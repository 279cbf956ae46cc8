"""Command-line interface.

Replaces the reference's windowed app (``src/main.cpp`` + the ImGui panel)
with a scriptable CLI:

    python -m ray_tracer_tpu.cli render scene.json -o out.png --spp 64
    python -m ray_tracer_tpu.cli render --preset cornell -o out.png
    python -m ray_tracer_tpu.cli info --preset cornell
    python -m ray_tracer_tpu.cli bench --preset cornell --spp 4

``render --progressive N`` runs N progressive frames with optional
``--checkpoint state.npz`` save/resume (the capability the reference lacks,
SURVEY.md §5).  A structured render report (Mrays/s, spp, wall time, BVH
stats) replaces the reference's stdout prints + ImGui stats.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _build_scene(args):
    from .scene import presets, schema

    if args.scene:
        builder = schema.load_scene(args.scene)
    else:
        preset = args.preset or "cornell"
        if preset == "cornell":
            builder = presets.default_scene()
        elif preset == "cornell_spheres":
            builder = presets.cornell_spheres()
        elif preset == "sphere_diffuse":
            builder = presets.sphere_diffuse()
        elif preset == "sponza_proxy":
            builder = presets.sponza_proxy()
        else:  # treat as a mesh name inside the assets dir
            builder = presets.mesh_scene(preset)
    return builder


def _add_common(p):
    p.add_argument("scene", nargs="?", help="scene JSON path")
    p.add_argument("--preset", help="built-in scene: cornell, cornell_spheres, sphere_diffuse, or <mesh.obj>")
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--spp", type=int, default=16)
    p.add_argument("--bounces", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true", help="force CPU backend")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ray_tracer_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="render a scene to PNG")
    _add_common(pr)
    pr.add_argument("-o", "--output", default="out.png")
    pr.add_argument("--progressive", type=int, default=0, metavar="FRAMES",
                    help="progressive frames (spp each) instead of one pass")
    pr.add_argument("--checkpoint", help="progressive state file to save/resume")
    pr.add_argument("--sharded", action="store_true",
                    help="shard pixels over all visible devices")
    pr.add_argument("--orbit", type=int, default=0, metavar="FRAMES",
                    help="render FRAMES frames sweeping camera yaw +/-15deg "
                         "(the reference's interactive camera-move workload)")

    pi = sub.add_parser("info", help="print compiled scene statistics")
    _add_common(pi)

    pb = sub.add_parser("bench", help="time a render, print a report")
    _add_common(pb)
    pb.add_argument("--profile", metavar="DIR",
                    help="capture a jax.profiler trace of the timed render")

    pv = sub.add_parser("view", help="live progressive viewer (HTTP)")
    _add_common(pv)
    pv.add_argument("--port", type=int, default=8787)
    pv.add_argument("--host", default="127.0.0.1",
                    help="bind address (default loopback; 0.0.0.0 exposes "
                         "the viewer and its camera endpoint to the network)")

    args = ap.parse_args(argv)

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    from .utils.cache import enable_compile_cache

    enable_compile_cache()
    from . import ProgressiveRenderer, RenderConfig, render_frame
    from .integrator import film

    cfg = RenderConfig(
        width=args.width,
        height=args.height,
        samples_per_pixel=args.spp,
        bounce_limit=args.bounces,
        seed=args.seed,
    )
    t0 = time.perf_counter()
    builder = _build_scene(args)
    scene = builder.compile()
    compile_s = time.perf_counter() - t0

    if args.cmd == "info":
        meta = dict(scene.meta)
        meta["scene_compile_s"] = round(compile_s, 3)
        meta["bvh_nodes"] = int(scene.bvh_index.shape[0])
        print(json.dumps(meta, default=str, indent=2))
        return 0

    scene_dev = scene.device_put()

    if args.cmd == "view":
        from . import viewer

        # the builder (not the compiled scene) enables the live editors
        viewer.serve(builder, cfg, port=args.port, host=args.host)
        return 0

    if args.cmd == "bench":
        import contextlib

        import jax

        img = render_frame(scene_dev, cfg)  # compile + run
        prof = (
            jax.profiler.trace(args.profile)
            if getattr(args, "profile", None)
            else contextlib.nullcontext()
        )
        t0 = time.perf_counter()
        with prof:
            img = render_frame(scene_dev, cfg)
            jax.block_until_ready(img)
        dt = time.perf_counter() - t0
        n_primary = cfg.n_pixels * cfg.samples_per_pixel
        print(json.dumps({
            "wall_s": round(dt, 4),
            "primary_rays": n_primary,
            "primary_mrays_per_s": round(n_primary / dt / 1e6, 3),
            "spp": cfg.samples_per_pixel,
            "resolution": f"{cfg.width}x{cfg.height}",
            "device": str(jax.devices()[0]),
        }))
        return 0

    # render
    if args.orbit > 0:
        from .scene.types import Camera

        base = None
        from .api import scene_camera

        base = scene_camera(scene)
        stem, ext = os.path.splitext(args.output)
        times = []
        img = None
        for i in range(args.orbit):
            yaw = -15.0 + 30.0 * i / max(args.orbit - 1, 1)
            cam = Camera(
                position=base.position,
                angles_deg=(base.angles_deg[0], base.angles_deg[1] + yaw,
                            base.angles_deg[2]),
                fov=base.fov,
                near_plane=base.near_plane,
            )
            t1 = time.perf_counter()
            img = render_frame(scene_dev, cfg, cam, frame=i)
            film.write_png(f"{stem}_{i:03d}{ext}", img)
            times.append(time.perf_counter() - t1)
        print(json.dumps({
            "output": f"{stem}_*{ext}",
            "frames": args.orbit,
            "mean_frame_s": round(sum(times) / len(times), 4),
            "first_frame_s": round(times[0], 4),
        }))
        return 0
    if args.sharded:
        import jax

        from .parallel import mesh as pmesh

        m = pmesh.make_mesh(n_data=len(jax.devices()))
        img = pmesh.render_frame_sharded(scene, cfg, m)
    elif args.progressive > 0:
        pr_ = ProgressiveRenderer(scene_dev, cfg)
        if args.checkpoint and os.path.exists(args.checkpoint):
            pr_.load_state(args.checkpoint)
            print(f"resumed at frame {pr_.frame}", file=sys.stderr)
        img = pr_.accum
        for _ in range(args.progressive):
            img = pr_.step()
        if args.checkpoint:
            pr_.save_state(args.checkpoint)
    else:
        img = render_frame(scene_dev, cfg)

    dt = time.perf_counter() - t0
    film.write_png(args.output, img)
    report = {
        "output": args.output,
        "resolution": f"{cfg.width}x{cfg.height}",
        "spp": cfg.samples_per_pixel * max(1, args.progressive),
        "wall_s": round(dt, 3),
        "scene_compile_s": round(compile_s, 3),
        "tris": scene.meta.get("n_tris", 0),
        "bvh_nodes": int(scene.bvh_index.shape[0]),
    }
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
