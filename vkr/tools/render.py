"""Headless render CLI — the app/frame-loop analog (reference main.cpp).

Renders a scene through the FULL pass chain (G-buffer, hi-Z, SSR, GTAO,
shading, TAA) and writes a PNG. Examples:

    JAX_PLATFORMS=cpu python -m vkr.tools.render --size 256 \
        --out frame.png --dump-dag
    python -m vkr.tools.render --scene sponza --width 1920 \
        --height 1080 --frames 8 --out frame.png

--scene takes a preset name or the path of a glTF file.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

SCENE_PRESETS = {
    "colonnade": {
        "eye": (-8.0, 2.2, -2.0),
        "center": (4.0, 1.8, 0.5),
    },
    # the bench workload (bench.py): Sponza-scale geometry and textures
    "sponza": {
        "eye": (-18.0, 2.2, -2.0),
        "center": (4.0, 1.8, 0.5),
    },
}


def load_preset(name: str, tex_size: int, columns: int = 8,
                native_sizes: bool = False):
    from vkr.scene import colonnade_scene, load_scene
    from vkr.scene.procedural import sponza_colonnade_scene

    preset = SCENE_PRESETS.get(name)
    if preset is None:
        preset = {"path": name, "eye": (0, 1, -3), "center": (0, 0, 0)}
    if "path" in preset:
        scene = load_scene(preset["path"], tex_size=tex_size,
                           native_sizes=native_sizes)
    elif name == "sponza":
        scene = sponza_colonnade_scene(columns=24, tessellation=80,
                                       tex_size=tex_size)
    else:
        scene = colonnade_scene(columns=columns, tessellation=24,
                                tex_size=tex_size)
    return scene, preset


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--scene", default="colonnade")
    parser.add_argument("--size", type=int, default=None)
    parser.add_argument("--width", type=int, default=512)
    parser.add_argument("--height", type=int, default=512)
    parser.add_argument("--tex-size", type=int, default=256)
    parser.add_argument("--native-sizes", action="store_true",
                        help="per-texture native resolution/aspect "
                             "(scene.cpp:104-161 parity mode)")
    parser.add_argument("--lut-size", type=int, default=256)
    parser.add_argument("--frames", type=int, default=1)
    parser.add_argument("--out", default="captures/frame.png")
    parser.add_argument("--dump-dag", action="store_true")
    parser.add_argument("--no-pallas", action="store_true")
    parser.add_argument("--no-ssr", action="store_true")
    parser.add_argument("--no-gtao", action="store_true")
    parser.add_argument("--no-taa", action="store_true")
    parser.add_argument("--show", default="color",
                        choices=["color", "albedo", "normal", "depth",
                                 "ao", "ssr", "velocity"])
    parser.add_argument("--ssr-iters", type=int, default=None)
    parser.add_argument("--orbit", type=float, default=0.0,
                        help="radians/frame camera orbit (animates)")
    args = parser.parse_args(argv)

    if args.size:
        args.width = args.height = args.size

    from vkr.core.platform import ensure_platform, pallas_interpret

    print("backend:", ensure_platform())
    import dataclasses

    import jax
    import jax.numpy as jnp

    from vkr.config import RenderConfig, SSRConfig
    from vkr.core.framestate import FrameState
    from vkr.core.graph import PassGraph
    from vkr.core.readback import save_png
    from vkr.frame import (
        build_ssr_resources,
        camera_frame,
        render_frame,
    )
    from vkr.mathlib import look_at
    from vkr.passes.gbuffer import upload_scene

    cfg = RenderConfig(
        width=args.width, height=args.height,
        enable_ssr=not args.no_ssr, enable_gtao=not args.no_gtao,
        enable_taa=not args.no_taa,
    )
    if args.ssr_iters:
        cfg = dataclasses.replace(
            cfg, ssr=dataclasses.replace(cfg.ssr,
                                         max_iterations=args.ssr_iters)
        )

    scene_cpu, preset = load_preset(args.scene, args.tex_size, native_sizes=args.native_sizes)
    print(f"scene: {scene_cpu.num_triangles} triangles, "
          f"{len(scene_cpu.positions)} vertices")
    scene = upload_scene(scene_cpu)
    ssr_res = build_ssr_resources(args.lut_size)

    interpret = pallas_interpret()

    def frame_fn(scene_in, state, cam):
        return render_frame(
            scene_in, state, cam, ssr_res, cfg,
            use_pallas=not args.no_pallas, interpret=interpret,
        )

    if args.dump_dag:
        graph = PassGraph()
        state0 = FrameState.initial(cfg.height, cfg.width)
        cam0 = camera_frame(cfg, np.eye(4, dtype=np.float32),
                            np.eye(4, dtype=np.float32), 0)
        with graph.recording():
            jax.eval_shape(frame_fn, scene, state0, cam0)
        print(graph.dump())

    jitted = jax.jit(frame_fn, donate_argnums=(1,))

    eye = np.asarray(preset["eye"], np.float32)
    center = np.asarray(preset["center"], np.float32)

    def view_at(i):
        if args.orbit:
            ang = args.orbit * i
            rot = np.array(
                [[np.cos(ang), 0, -np.sin(ang)],
                 [0, 1, 0],
                 [np.sin(ang), 0, np.cos(ang)]], np.float32)
            e = center + rot @ (eye - center)
        else:
            e = eye
        return look_at(e, center, (0, -1, 0))

    state = FrameState.initial(cfg.height, cfg.width)
    prev_view = view_at(0)

    t0 = time.perf_counter()
    view = view_at(0)
    cam = camera_frame(cfg, view, prev_view, 0)
    color, state, aux = jitted(scene, state, cam)
    _ = np.asarray(color[0, 0])
    print(f"compile+first: {(time.perf_counter()-t0)*1e3:.1f} ms")

    times = []
    for i in range(1, args.frames):
        prev_view, view = view, view_at(i)
        cam = camera_frame(cfg, view, prev_view, i)
        t0 = time.perf_counter()
        color, state, aux = jitted(scene, state, cam)
        _ = np.asarray(color[0, 0])
        times.append(time.perf_counter() - t0)
    if times:
        print(f"steady frame: {np.median(times)*1e3:.2f} ms "
              f"(min {min(times)*1e3:.2f})")

    gbuf = aux["gbuffer"]
    outputs = {
        "color": lambda: np.asarray(color),
        "albedo": lambda: np.asarray(gbuf.albedo[..., :3]),
        "normal": lambda: np.asarray(
            np.concatenate([np.asarray(gbuf.normal),
                            np.zeros((cfg.height, cfg.width, 1))], -1)),
        "depth": lambda: 1.0 - np.asarray(gbuf.depth),
        "ao": lambda: np.asarray(aux["ao"]),
        "ssr": lambda: np.asarray(aux["ssr"]),
        "velocity": lambda: np.abs(np.asarray(gbuf.velocity)) * 50,
    }
    img = outputs[args.show]()
    coverage = float(np.mean(np.asarray(gbuf.depth) < 1.0))
    print(f"coverage: {coverage:.3f}")
    save_png(img, args.out, srgb_encode=args.show in ("color", "albedo",
                                                      "ssr"))
    print("saved", args.out)


if __name__ == "__main__":
    main()
