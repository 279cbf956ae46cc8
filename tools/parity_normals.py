#!/usr/bin/env python
"""Root-cause breakdown of the obj_normals parity residual (the one
pinned-camera gallery case, fov 50 / rot (4,-89,0) / pos (-3,-0.5,-1) /
bounce 1).

Stage 1 (``render``): render the reconstruction at the pinned pose and
cache it (renders/parity/obj_normals_ours.npy) — ~20 min on CPU.

Stage 2 (``analyze``): REGISTER the render against the screenshot before
any comparison.  tools/parity.py's brightness auto-crop is built for
unknown-camera screenshots; at a pinned camera it leaves a residual
translation/scale error that dominates the MSE (measured: the
misregistered "weapon" region of our crop sampled pure sky).  Here the
viewport rectangle inside the 3456x2234 screenshot is solved directly:
scan (scale, x0, y0) with the screenshot's ImGui panel and macOS dock
masked out, minimizing masked MSE; then report per-region residuals
(sky / env ground / planet / weapon, segmented on the reference) at the
solved registration.

Usage:
  python tools/parity_normals.py render [spp]
  python tools/parity_normals.py analyze
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

OUT = os.path.join(os.path.dirname(__file__), "..", "renders", "parity")
CACHE = os.path.join(OUT, "obj_normals_ours.npy")
REF_PNG = os.path.join(
    os.environ.get("RT_REFERENCE_RENDERS", "reference_renders"),
    "obj_normals.png",
)
W, H = 864, 558  # half the reference window (vk_engine.h:338)


def render(spp: int) -> None:
    if os.environ.get("RT_PARITY_CPU"):
        import jax

        jax.config.update("jax_platforms", "cpu")
    from ray_tracer_tpu import RenderConfig
    from ray_tracer_tpu.api import render_frame
    from ray_tracer_tpu.scene import presets

    scene = presets.obj_normals_demo().compile().device_put()
    acc = np.zeros((H, W, 3), np.float32)
    done = 0
    while done < spp:
        c = min(8, spp - done)
        cfg = RenderConfig(
            width=W, height=H, samples_per_pixel=c, bounce_limit=1,
            max_rays_per_batch=1 << 17,
        )
        acc += np.asarray(render_frame(scene, cfg, sample_base=done)) * (
            c / spp
        )
        done += c
        print(f"  {done}/{spp} spp", file=sys.stderr, flush=True)
    os.makedirs(OUT, exist_ok=True)
    np.save(CACHE, acc)
    print(f"cached {CACHE}")


def _resize(img, w, h):
    from PIL import Image

    im = Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8))
    return np.asarray(im.resize((w, h), Image.BILINEAR), np.float32) / 255.0


def analyze() -> None:
    from parity import load_ref, srgb_encode

    ours = srgb_encode(np.load(CACHE))
    ref = load_ref(REF_PNG)
    rh, rw = ref.shape[:2]

    # screenshot furniture, in reference-pixel fractions (measured on the
    # 3456x2234 capture): macOS menu bar, dock, and the in-viewport ImGui
    # panel.  Excluded from BOTH the registration fit and the stats.
    furn = np.zeros((rh, rw), bool)
    furn[: int(0.035 * rh)] = True                      # menu bar
    furn[int(0.90 * rh):, int(0.15 * rw): int(0.85 * rw)] = True  # dock
    furn[int(0.030 * rh): int(0.27 * rh), int(0.76 * rw):] = True  # ImGui

    # ---- registration: solve the viewport rect (x0, y0, s) ------------
    # rect width = s * rw, aspect locked to ours (W/H)
    small_w = 216
    small_h = int(small_w * H / W)
    ours_s = _resize(ours, small_w, small_h)

    def masked_mse(s, fx, fy):
        bw, bh = int(s * rw), int(s * rw * H / W)
        x0, y0 = int(fx * rw), int(fy * rh)
        if x0 < 0 or y0 < 0 or x0 + bw > rw or y0 + bh > rh:
            return np.inf, None
        crop = _resize(ref[y0: y0 + bh, x0: x0 + bw], small_w, small_h)
        fm = _resize(
            furn[y0: y0 + bh, x0: x0 + bw].astype(np.float32),
            small_w, small_h,
        ) < 0.5
        return float(np.mean(((crop - ours_s) ** 2)[fm])), None

    best = (np.inf, None)
    for s in np.arange(0.80, 1.001, 0.02):
        for fy in np.arange(0.0, 1.0 - s * (rw / rh) * H / W + 1e-9, 0.02):
            for fx in np.arange(0.0, 1.0 - s + 1e-9, 0.02):
                m, _ = masked_mse(s, fx, fy)
                if m < best[0]:
                    best = (m, (s, fx, fy))
    # refine
    s, fx, fy = best[1]
    for ds in np.arange(-0.015, 0.016, 0.005):
        for dy in np.arange(-0.015, 0.016, 0.005):
            for dx in np.arange(-0.015, 0.016, 0.005):
                m, _ = masked_mse(s + ds, fx + dx, fy + dy)
                if m < best[0]:
                    best = (m, (s + ds, fx + dx, fy + dy))
    s, fx, fy = best[1]
    print(f"registration: scale {s:.3f}, origin ({fx:.3f}, {fy:.3f}) "
          f"of {rw}x{rh}, masked MSE {best[0]:.4f}")

    # ---- full-res comparison at the solved registration ---------------
    bw, bh = int(s * rw), int(s * rw * H / W)
    x0, y0 = int(fx * rw), int(fy * rh)
    a = _resize(ref[y0: y0 + bh, x0: x0 + bw], W, H)
    fm = _resize(
        furn[y0: y0 + bh, x0: x0 + bw].astype(np.float32), W, H
    ) < 0.5
    b = ours

    r, g, bl = a[..., 0], a[..., 1], a[..., 2]
    planet = (g > r + 0.15) & (g > bl + 0.15) & (g > 0.4) & fm
    sky = (bl > r + 0.02) & (bl > 0.55) & ~planet & fm
    chroma = a.max(-1) - a.min(-1)
    ground = (chroma < 0.06) & (a.max(-1) > 0.35) & ~planet & ~sky & fm
    weapon = fm & ~(planet | sky | ground)

    print("\n| region | area % | MSE (sRGB) | MAE | ref mean RGB "
          "| ours mean RGB |")
    print("|---|---|---|---|---|---|")
    for name, m in [("full (furniture-masked)", fm), ("sky", sky),
                    ("env ground", ground), ("planet", planet),
                    ("weapon+edges (remainder)", weapon),
                    ("background = full - weapon", fm & ~weapon)]:
        if m.sum() == 0:
            continue
        mse = float(np.mean(((a - b) ** 2)[m]))
        mae = float(np.mean(np.abs(a - b)[m]))
        ra, rb_ = a[m].mean(0), b[m].mean(0)
        print(f"| {name} | {100 * m.mean():.1f} | {mse:.4f} | {mae:.3f} "
              f"| {ra[0]:.3f},{ra[1]:.3f},{ra[2]:.3f} "
              f"| {rb_[0]:.3f},{rb_[1]:.3f},{rb_[2]:.3f} |")

    from PIL import Image

    side = np.concatenate(
        [a * fm[..., None], np.ones((H, 4, 3), np.float32),
         b * fm[..., None]], axis=1)
    Image.fromarray((np.clip(side, 0, 1) * 255).astype(np.uint8)).save(
        os.path.join(OUT, "obj_normals_registered.png"))
    seg = a.copy()
    seg[planet] = seg[planet] * 0.5 + np.array([0, 0.5, 0])
    seg[sky] = seg[sky] * 0.5 + np.array([0, 0, 0.5])
    seg[ground] = seg[ground] * 0.5 + np.array([0.5, 0.5, 0])
    seg[~fm] = 0
    Image.fromarray((np.clip(seg, 0, 1) * 255).astype(np.uint8)).save(
        os.path.join(OUT, "obj_normals_segments.png"))
    diff = np.abs(a - b).mean(-1) * fm
    Image.fromarray(
        (np.clip(diff * 3, 0, 1) * 255).astype(np.uint8)).save(
        os.path.join(OUT, "obj_normals_diff.png"))


if __name__ == "__main__":
    cmd = sys.argv[1] if len(sys.argv) > 1 else "analyze"
    if cmd == "render":
        render(int(sys.argv[2]) if len(sys.argv) > 2 else 32)
    else:
        analyze()
