"""BVH builder invariants + octant threading (SURVEY.md §4)."""

import numpy as np
import pytest

from ray_tracer_tpu.accel import bvh


def random_tris(rng, n, spread=10.0):
    base = rng.uniform(-spread, spread, (n, 1, 3)).astype(np.float32)
    offs = rng.uniform(-0.5, 0.5, (n, 3, 3)).astype(np.float32)
    return base + offs


@pytest.fixture
def forest_and_perm(rand):
    tris = random_tris(rand, 200)
    forest, perm = bvh.build_forest(tris.copy(), [(0, 200)], max_leaf_tris=4)
    return tris, forest, perm


def test_perm_is_permutation(forest_and_perm):
    _, _, perm = forest_and_perm
    assert sorted(perm.tolist()) == list(range(200))


def test_leaves_cover_all_tris_once(forest_and_perm):
    _, forest, _ = forest_and_perm
    leaf = forest.tri_count > 0
    covered = []
    for i in np.nonzero(leaf)[0]:
        covered.extend(range(forest.index[i], forest.index[i] + forest.tri_count[i]))
    assert sorted(covered) == list(range(200))


def test_leaf_size_bounded(forest_and_perm):
    _, forest, _ = forest_and_perm
    assert forest.max_leaf_tris <= 4
    assert int(forest.tri_count.max()) <= 4


def test_bounds_contain_children(forest_and_perm):
    tris, forest, perm = forest_and_perm
    reordered = tris[perm]
    tmin = reordered.min(axis=1)
    tmax = reordered.max(axis=1)
    for i in range(forest.n_nodes):
        if forest.tri_count[i] > 0:
            lo, hi = forest.index[i], forest.index[i] + forest.tri_count[i]
            assert np.all(forest.node_min[i] <= tmin[lo:hi].min(axis=0) + 1e-5)
            assert np.all(forest.node_max[i] >= tmax[lo:hi].max(axis=0) - 1e-5)
        else:
            c = forest.index[i]
            for ch in (c, c + 1):
                assert np.all(forest.node_min[i] <= forest.node_min[ch] + 1e-5)
                assert np.all(forest.node_max[i] >= forest.node_max[ch] - 1e-5)


def test_threading_visits_every_node_per_octant(forest_and_perm):
    """Following hit links (always descend) or miss links must terminate and,
    for the all-hit walk, enumerate a DFS that reaches every node."""
    _, forest, _ = forest_and_perm
    n = forest.n_nodes
    for o in range(8):
        # Walk simulating "AABB always hit": interior -> hit link, leaf -> miss.
        seen = set()
        node = forest.roots[0]
        steps = 0
        while node != bvh.SENTINEL and steps < 10 * n:
            seen.add(int(node))
            if forest.tri_count[node] > 0:
                node = forest.miss_link[o, node]
            else:
                node = forest.hit_link[o, node]
            steps += 1
        assert steps < 10 * n, "threading loop did not terminate"
        assert len(seen) == n, f"octant {o} DFS missed nodes"


def test_multiple_groups_get_separate_roots(rand):
    tris = random_tris(rand, 60)
    forest, _ = bvh.build_forest(tris, [(0, 30), (30, 30)], max_leaf_tris=2)
    assert len(forest.roots) == 2
    r0, r1 = forest.roots
    # group 1's leaves must only reference tris >= 30
    stack = [r1]
    while stack:
        i = stack.pop()
        if forest.tri_count[i] > 0:
            assert forest.index[i] >= 30
        else:
            stack.extend([forest.index[i], forest.index[i] + 1])


def test_single_triangle_group():
    tris = np.zeros((1, 3, 3), np.float32)
    tris[0] = [[0, 0, 0], [1, 0, 0], [0, 1, 0]]
    forest, perm = bvh.build_forest(tris, [(0, 1)])
    assert forest.n_nodes == 1
    assert forest.tri_count[0] == 1


def test_sponza_proxy_hardness():
    """The scored BASELINE-config-5 workload must stay Sponza-hard:
    triangle count anchored to the real Crytek
    asset (262,267), and a tree at least as SAH-expensive as the densest
    in-repo real mesh (klein_bottle, SAH~53 by tools/scene_hardness.py's
    metric) — guarding against the scene degenerating into cheap
    spread-out geometry that inflates Mrays/s."""
    import sys, os
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from tools.scene_hardness import bvh_stats

    from ray_tracer_tpu.scene import presets

    s = presets.sponza_proxy().compile()
    st = bvh_stats(s)
    assert 240_000 <= st["n_tris"] <= 290_000, st
    assert st["sah_cost"] >= 45.0, st
    assert st["max_depth"] >= 18, st
    # determinism in the seed (bench comparability across rounds)
    s2 = presets.sponza_proxy().compile()
    assert np.array_equal(np.asarray(s.tri_v0), np.asarray(s2.tri_v0))
