#!/usr/bin/env python
"""End-to-end interactive preview rate of the viewer.

The reference is an interactive app whose UX bar is the ImGui fps
display (vk_engine.cpp:1497-1501); during camera movement it re-renders
1-spp full-res frames (vk_engine.cpp:1867-1891).  This viewer's
answer is the low-res instant preview (viewer.py): after any camera
move the next tick renders width/preview_scale x height/preview_scale
at 1 spp and publishes a PNG.

This harness times the FULL tick path (render step + sRGB encode + PNG)
through ViewerState._tick — exactly what a dragging camera experiences —
for the camera-drag preview, plus the steady-state full-res progressive
frame, on the bench scene (sponza_proxy, default route) and the
default cornell scene.

Usage: python tools/measure_viewer_fps.py [n_tris] [scales...]
Env: VF_SPP (full-res spp/frame, default 2), VF_W/VF_H (default 1920x1080)
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    from ray_tracer_tpu import RenderConfig
    from ray_tracer_tpu.scene import presets
    from ray_tracer_tpu.viewer import ViewerState

    n_tris = int(sys.argv[1]) if len(sys.argv) > 1 else 260_000
    scales = [int(s) for s in sys.argv[2:]] or [4, 6, 8]
    W = int(os.environ.get("VF_W", 1920))
    H = int(os.environ.get("VF_H", 1080))
    spp = int(os.environ.get("VF_SPP", 2))

    for name, builder in (
        ("sponza_proxy", presets.sponza_proxy(n_tris)),
        ("cornell", presets.default_scene()),
    ):
        scene = builder.compile().device_put()
        for scale in scales:
            cfg = RenderConfig(
                width=W, height=H, samples_per_pixel=spp, bounce_limit=8
            )
            st = ViewerState(scene, cfg, preview_scale=scale)
            pw, ph = st.preview.cfg.width, st.preview.cfg.height

            # camera drag: every tick re-renders the preview after a move
            st._tick()  # compile warmup (preview path: both frames == 0)
            times = []
            import dataclasses

            cam = st.renderer.camera
            for i in range(8):
                # nudge the camera like a drag event (resets both frames)
                moved = dataclasses.replace(
                    cam,
                    angles_deg=(
                        cam.angles_deg[0],
                        cam.angles_deg[1] + 0.5 * (i + 1),
                        cam.angles_deg[2],
                    ),
                )
                st.renderer.move_camera(moved)
                st.preview.move_camera(moved)
                t0 = time.perf_counter()
                st._tick()
                times.append(time.perf_counter() - t0)
                assert st.latest_is_preview
            pbest = min(times[1:])
            print(
                f"{name:13s} scale={scale} preview {pw}x{ph}@1spp: "
                f"{pbest*1e3:7.1f} ms  {1.0/pbest:5.1f} fps",
                flush=True,
            )

        # steady-state full-res progressive frame (no scale dependence)
        st._tick()  # leave preview mode (frame 0 -> full res)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            st._tick()
            times.append(time.perf_counter() - t0)
            assert not st.latest_is_preview
        fbest = min(times)
        print(
            f"{name:13s} full {W}x{H}@{spp}spp progressive: "
            f"{fbest*1e3:7.1f} ms  {1.0/fbest:5.2f} fps",
            flush=True,
        )
        st.running = False


if __name__ == "__main__":
    main()
