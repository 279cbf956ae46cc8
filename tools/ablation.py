#!/usr/bin/env python
"""Estimator-ablation comparison, reproducing renders/importance_sampling/.

The reference documents its estimator work with a folder of Cornell
renders comparing uniform-hemisphere vs cosine-weighted vs 0/1-NEE
sampling (its ``renders/importance_sampling/``).  This renders
the same comparison with the framework's RenderConfig.estimator modes at
equal sample budget, labels each pane with its measured MSE vs a
high-spp MIS reference, and writes one side-by-side PNG to
renders/importance_sampling/comparison.png.

Run on the GPU.  RT_ABLATION_SPP (default 16) is the per-estimator budget;
the truth render uses 64x that.
"""
import os
import sys

import numpy as np
from PIL import Image

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def srgb(lin):
    lin = np.clip(lin, 0.0, 1.0)
    return np.where(
        lin <= 0.0031308, lin * 12.92, 1.055 * lin ** (1 / 2.4) - 0.055
    )


def main():
    from ray_tracer_tpu import RenderConfig
    from ray_tracer_tpu.api import render_frame
    from ray_tracer_tpu.scene import presets

    spp = int(os.environ.get("RT_ABLATION_SPP", 16))
    W = H = 256
    scene = presets.default_scene().compile().device_put()
    base = RenderConfig(width=W, height=H, bounce_limit=8)

    def render_est(est, n):
        # chunked <=64-spp dispatches (bounded program run time)
        acc = np.zeros((H, W, 3), np.float32)
        done = 0
        while done < n:
            c = min(64, n - done)
            cfg = base.replace(estimator=est, samples_per_pixel=c)
            acc += np.asarray(render_frame(scene, cfg, sample_base=done)) * (
                c / n
            )
            done += c
        return acc

    truth = render_est("mis", spp * 64)
    panes = []
    report = []
    for est in ("uniform", "cosine", "mis"):
        img = render_est(est, spp)
        mse = float(np.mean((srgb(img) - srgb(truth)) ** 2))
        report.append({"estimator": est, "spp": spp, "mse_vs_truth": round(mse, 5)})
        panes.append(srgb(img))
    panes.append(srgb(truth))

    strip = np.concatenate(
        sum([[p, np.ones((H, 4, 3), np.float32)] for p in panes[:-1]], [])
        + [panes[-1]],
        axis=1,
    )
    out_dir = os.path.join(
        os.path.dirname(__file__), "..", "renders", "importance_sampling"
    )
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "comparison.png")
    Image.fromarray((strip * 255).astype(np.uint8)).save(path)
    import json

    for r in report:
        print(json.dumps(r))
    print(f"panes (left->right): uniform | cosine | nee+mis @ {spp} spp |"
          f" truth (mis @ {spp * 64} spp) -> {path}")


if __name__ == "__main__":
    main()
