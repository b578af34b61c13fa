"""Parity measurement: the kernel pipeline vs the jnp oracle, per
G-buffer channel, pass and final frame (PSNR).

The BASELINE configs call for PSNR >= 40 dB per pass against reference
renders; without a Vulkan device, the measurable analog is the kernel
route (`use_pallas=True`: tile raster + march kernels) against the
straightforward oracle route (`use_pallas=False`: brute-force raster +
plain XLA march). Both implement the reference algorithms.

    python -m vkr.tools.parity --size 256
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def psnr(a, b, peak=1.0):
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(peak * peak / mse)


def measure(scene: str = "colonnade", size: int = 256,
            tex_size: int = 128, lut_size: int = 128, frames: int = 3,
            interpret: bool = False) -> dict:
    """Render `frames` frames through both routes; returns
    {pass/channel: PSNR dB of the kernel route against the oracle}."""
    import dataclasses

    import jax

    from vkr.config import RenderConfig
    from vkr.core.framestate import FrameState
    from vkr.frame import (build_ssr_resources, camera_frame,
                               render_frame)
    from vkr.mathlib import look_at
    from vkr.passes.gbuffer import upload_scene
    from vkr.tools.render import load_preset

    cfg = RenderConfig(width=size, height=size)
    cfg = dataclasses.replace(
        cfg, ssr=dataclasses.replace(cfg.ssr, max_iterations=32)
    )
    scene_cpu, preset = load_preset(scene, tex_size)
    scene_dev = upload_scene(scene_cpu)
    ssr_res = build_ssr_resources(lut_size)
    view = look_at(preset["eye"], preset["center"], (0, -1, 0))

    outs = {}
    for mode, use_pallas in (("kernel", True), ("oracle", False)):
        state = FrameState.initial(cfg.height, cfg.width)
        f = jax.jit(
            lambda s, st, c, up=use_pallas: render_frame(
                s, st, c, ssr_res, cfg, use_pallas=up,
                interpret=interpret,
            )
        )
        for i in range(frames):
            cam = camera_frame(cfg, view, view, i)
            color, state, aux = f(scene_dev, state, cam)
        g = aux["gbuffer"]
        outs[mode] = dict(
            albedo=g.albedo, normal=g.normal, depth=g.depth,
            velocity=g.velocity, material=g.material,
            ao=aux["ao"], ssr=aux["ssr"], color=color,
        )
    return {key: round(psnr(outs["kernel"][key], outs["oracle"][key]), 2)
            for key in outs["kernel"]}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--scene", default="colonnade")
    parser.add_argument("--size", type=int, default=256)
    parser.add_argument("--tex-size", type=int, default=128)
    parser.add_argument("--lut-size", type=int, default=128)
    parser.add_argument("--frames", type=int, default=3)
    args = parser.parse_args(argv)

    from vkr.core.platform import ensure_platform, pallas_interpret

    print("backend:", ensure_platform())
    results = measure(args.scene, args.size, args.tex_size, args.lut_size,
                      args.frames, interpret=pallas_interpret())
    print(json.dumps({"psnr_kernel_vs_oracle_db": results}))
    return results


if __name__ == "__main__":
    main()
