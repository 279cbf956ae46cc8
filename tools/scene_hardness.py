#!/usr/bin/env python
"""Is sponza_proxy actually Sponza-hard?

The reference ships ``assets/sponza2/sponza.mtl`` + the full Crytek
texture set but NO sponza .obj (the load is commented out,
``vk_engine.cpp:729``; PARITY.md), so BASELINE config 5 runs on the
procedural ``presets.sponza_proxy``.  This tool substantiates the proxy's
hardness with measurable BVH-quality numbers:

* structural: tri count, node count, depth distribution, SAH cost — the
  quantities the reference prints per build (``vk_engine.cpp:1189-1193``);
* behavioral (--heatmap, needs a fast backend): mean box/tri tests per
  primary ray and per full path from the debug counters — the
  reference's stats[2] heatmap numbers (``raytrace.comp:583-591``).

Comparison anchors for the real Crytek Sponza (public knowledge, no
fetch): 262,267 triangles, ~25 materials, SAH BVH depth ~35-45 at 2-tri
leaves.  The proxy matches the triangle count by construction; the
numbers below show whether its tree is comparably deep/costly.
"""
import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def bvh_stats(scene):
    mn = np.asarray(scene.bvh_min)
    mx = np.asarray(scene.bvh_max)
    idx = np.asarray(scene.bvh_index)
    cnt = np.asarray(scene.bvh_tri_count)
    root = int(np.asarray(scene.obj_bvh_root)[0])

    ext = np.maximum(mx - mn, 0.0)
    area = 2.0 * (
        ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2] + ext[:, 0] * ext[:, 2]
    )
    root_area = max(float(area[root]), 1e-20)

    # BFS from root for per-node depth
    depth = np.full(idx.shape[0], -1, np.int64)
    depth[root] = 0
    stack = [root]
    while stack:
        n = stack.pop()
        if cnt[n] == 0:  # interior: children at idx[n], idx[n]+1
            for c in (idx[n], idx[n] + 1):
                depth[c] = depth[n] + 1
                stack.append(int(c))
    reach = depth >= 0
    leaf = reach & (cnt > 0)
    interior = reach & (cnt == 0)

    # standard SAH cost with C_trav=1, C_isect=1
    sah = float(
        (area[interior].sum() + (area[leaf] * cnt[leaf]).sum()) / root_area
    )
    leaf_depths = depth[leaf]
    return {
        "n_tris": int(scene.meta["n_tris"]),
        "n_nodes": int(reach.sum()),
        "n_leaves": int(leaf.sum()),
        "max_depth": int(depth.max()),
        "mean_leaf_depth": round(float(leaf_depths.mean()), 1),
        "p95_leaf_depth": int(np.percentile(leaf_depths, 95)),
        "mean_leaf_tris": round(float(cnt[leaf].mean()), 2),
        "sah_cost": round(sah, 1),
    }


def heatmap_stats(scene, width=320, height=200):
    from ray_tracer_tpu import RenderConfig
    from ray_tracer_tpu.api import render_debug

    cfg = RenderConfig(width=width, height=height, samples_per_pixel=1)
    cap = 1e9  # raw counts
    img_full = np.asarray(render_debug(scene, cfg, mode=2, box_cap=cap,
                                       tri_cap=cap)) * cap
    cfg0 = cfg.replace(bounce_limit=0)
    img_prim = np.asarray(render_debug(scene, cfg0, mode=2, box_cap=cap,
                                       tri_cap=cap)) * cap
    return {
        "box_tests_per_primary_ray": round(float(img_prim[..., 0].mean()), 1),
        "tri_tests_per_primary_ray": round(float(img_prim[..., 2].mean()), 1),
        "box_tests_per_path": round(float(img_full[..., 0].mean()), 1),
        "tri_tests_per_path": round(float(img_full[..., 2].mean()), 1),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--heatmap", action="store_true",
                    help="also measure per-ray test counts (renders)")
    args = ap.parse_args()

    from ray_tracer_tpu.scene import presets

    scenes = {
        "cornell": presets.default_scene(),
        "sponza_proxy": presets.sponza_proxy(),
    }
    if os.path.exists(os.path.join(presets.DEFAULT_ASSETS, "klein_bottle.obj")):
        scenes["klein_bottle"] = presets.mesh_scene("klein_bottle.obj")
    out = {}
    for name, b in scenes.items():
        scene = b.compile()
        row = bvh_stats(scene)
        if args.heatmap:
            row.update(heatmap_stats(scene.device_put()))
        out[name] = row
        print(name, json.dumps(row), flush=True)
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
