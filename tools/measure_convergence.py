#!/usr/bin/env python
"""Convergence + time-to-quality across scenes.

The north-star convergence metric ("seconds to 1024 spp, Cornell 512^2",
BASELINE.md) covers Cornell only, the cheapest scene.  This measures,
for Cornell AND the mesh-BVH scenes (bunny, klein, sponza_proxy):

  * steady-state seconds to 1024 spp at 512^2 (compile excluded),
  * time-to-quality: cumulative seconds until the running mean's MSE vs
    an independent equal-spp truth (different seed) drops below
    thresholds — the progressive-preview quality the reference's
    interactive loop delivers (src/vk_engine.cpp:1782-1814).

Truth and measured render use the SAME estimator, so MSE_t converges to
~2x the per-image variance floor; the thresholds are absolute sRGB MSE.

Usage: python tools/measure_convergence.py [scene ...]
  env RT_CONV_SPP (default 1024), RT_CONV_SIZE (default 512).
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

THRESHOLDS = (3e-3, 1e-3, 3e-4, 1e-4)


def srgb(lin):
    lin = np.clip(lin, 0.0, 1.0)
    return np.where(
        lin <= 0.0031308, lin * 12.92, 1.055 * lin ** (1 / 2.4) - 0.055
    )


def main():
    from ray_tracer_tpu import RenderConfig
    from ray_tracer_tpu.api import render_frame
    from ray_tracer_tpu.scene import presets

    spp = int(os.environ.get("RT_CONV_SPP", 1024))
    size = int(os.environ.get("RT_CONV_SIZE", 512))
    chunk = min(128, spp)

    builders = {
        "cornell": lambda: presets.default_scene(),
        "bunny": lambda: presets.mesh_scene(
            "bunny.obj", material=presets.DIELECTRIC, scale=0.8,
            position=(0.0, 0.769, 0.0), rotation_deg=(0.0, 180.0, 0.0),
        ),
        "klein": lambda: presets.mesh_scene(
            "klein_bottle.obj", material=presets.WHITE, scale=0.15,
            position=(0.0, 0.5, 0.0),
        ),
        "sponza_proxy": lambda: presets.sponza_proxy(260_000),
    }
    wanted = sys.argv[1:] or list(builders)

    rows = []
    for name in wanted:
        scene = builders[name]().compile().device_put()
        cfg = RenderConfig(width=size, height=size, samples_per_pixel=chunk,
                           bounce_limit=8, seed=0)
        # truth: same spp, independent RNG stream (seed offset)
        tcfg = cfg.replace(seed=7777)
        truth = np.zeros((size, size, 3), np.float32)
        for s in range(0, spp, chunk):
            truth += np.asarray(
                render_frame(scene, tcfg, sample_base=s)) * (chunk / spp)
        truth_s = srgb(truth)

        # measured run: warm the compile with one chunk, then time
        np.asarray(render_frame(scene, cfg, sample_base=0))
        acc = np.zeros((size, size, 3), np.float32)
        t_cum = 0.0
        hits = {}
        per_chunk = []
        for i, s in enumerate(range(0, spp, chunk)):
            t0 = time.perf_counter()
            out = np.asarray(render_frame(scene, cfg, sample_base=s))
            t_cum += time.perf_counter() - t0
            acc += out * chunk
            mean = srgb(acc / (s + chunk))
            mse = float(np.mean((mean - truth_s) ** 2))
            per_chunk.append({"spp": s + chunk,
                              "s": round(t_cum, 1), "mse": round(mse, 6)})
            for th in THRESHOLDS:
                if th not in hits and mse < th:
                    hits[th] = round(t_cum, 1)
        row = {
            "scene": name, "size": size, "spp": spp,
            "seconds_to_full_spp": round(t_cum, 1),
            "time_to_mse": {str(k): v for k, v in hits.items()},
            "final_mse_vs_truth": per_chunk[-1]["mse"],
        }
        rows.append(row)
        print(json.dumps(row), flush=True)
        for pc in per_chunk:
            print(f"  {name} {pc['spp']:>5} spp  {pc['s']:>7}s  "
                  f"mse {pc['mse']}", file=sys.stderr, flush=True)

    print("\n| scene | s to %d spp | s to mse<3e-3 | <1e-3 | <3e-4 |" % spp)
    print("|---|---|---|---|---|")
    for r in rows:
        tm = r["time_to_mse"]
        print(f"| {r['scene']} | {r['seconds_to_full_spp']} |"
              f" {tm.get('0.003', '-')} | {tm.get('0.001', '-')} |"
              f" {tm.get('0.0003', '-')} |")


if __name__ == "__main__":
    main()
