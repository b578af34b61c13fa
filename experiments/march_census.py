"""Census of the SSR march workload on the bench frame: per iteration,
how many rays are still marching and on which mip they sit.

The march (passes/ssr_march.py) runs every half-res ray to the iteration
cap; its cost is the number of live ray-iterations and how scattered
their pyramid fetches are. This replays the plain march step by step on
bench frame 1 and prints the live count and mip histogram at a few
iterations.

    python experiments/march_census.py [downscale]
"""

from __future__ import annotations

import functools
import os
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def main():
    from vkr.core.platform import ensure_platform, pallas_interpret

    print("backend:", ensure_platform(), flush=True)
    import jax
    import jax.numpy as jnp
    import numpy as np

    from bench import bench_orbit_view
    from vkr.config import RenderConfig
    from vkr.core import registry
    from vkr.frame import _normal_mat4, build_ssr_resources, camera_frame
    from vkr.passes import ssr as S
    from vkr.passes import ssr_march as M
    from vkr.passes.gbuffer import upload_scene
    from vkr.scene.procedural import sponza_colonnade_scene

    scale = int(sys.argv[1]) if len(sys.argv) > 1 else 1
    W, H = 1920 // scale // 16 * 16, 1080 // scale // 16 * 16
    cfg = RenderConfig(width=W, height=H)
    scene = upload_scene(sponza_colonnade_scene(columns=24,
                                                tessellation=80,
                                                tex_size=64))
    cam = camera_frame(cfg, bench_orbit_view(1), bench_orbit_view(0), 1)
    gb = jax.jit(lambda s, c: registry.get("gbuf_opaque_taa")(
        s, c.mvp, c.prev_mvp, c.jitter, width=W, height=H,
        interpret=pallas_interpret()))(scene, cam)
    hiz = registry.get("downsample_hiz")(gb.depth, gb.normal, gb.velocity)
    pyr = S.pack_pyramid(hiz.mips)
    params = S.SSRParams(normal_mat=_normal_mat4(cam.view),
                         fovy=cfg.camera.fovy, aspect=cfg.aspect,
                         znear=cfg.camera.znear, zfar=cfg.camera.zfar)
    res = build_ssr_resources(64)
    rays = S.trace_rays(pyr, hiz.normal_half, gb.material, params,
                        jnp.int32(1), res.halton)

    screen = (float(pyr.widths[0]), float(pyr.heights[0]))
    offs = jnp.asarray(pyr.offsets)
    hs, ws = jnp.asarray(pyr.heights), jnp.asarray(pyr.widths)

    def fetch(mip, x, y):
        return pyr.flat[offs[mip] + jnp.clip(y, 0, hs[mip] - 1) * ws[mip]
                        + jnp.clip(x, 0, ws[mip] - 1)]

    split = lambda a: [a[..., k] for k in range(3)]  # noqa: E731
    c = M._consts(split(rays["ray_start"]), split(rays["ray_dir"]),
                  screen, 0)
    st = M._init_state(c, screen, 0,
                       jnp.zeros(rays["ray_start"].shape[:-1], bool))
    step = jax.jit(functools.partial(
        M._step, c=c, cam=split(rays["view_vec"]), w0=split(rays["w0"]),
        fetch=fetch, screen=screen, n_mips=len(pyr.offsets),
        view=M._view(params), find_hor=True, most_detailed_mip=0))
    n = int(np.prod(rays["ray_start"].shape[:-1]))
    print(f"trace grid {pyr.heights[0]}x{pyr.widths[0]} ({n} rays)")
    live_iters = 0
    for i in range(80):
        live = ~np.asarray(st["done"])
        live_iters += int(live.sum())
        if i in (0, 8, 15, 16, 24, 32, 48, 64, 79):
            mips = np.bincount(np.asarray(st["mip"])[live].clip(0),
                               minlength=4)[:6]
            print(f"iter {i:2d}: live {live.mean():.3f}  mip histogram "
                  f"{mips.tolist()}", flush=True)
        st = step(jnp.int32(i), st)
    print(f"live ray-iterations: {live_iters} "
          f"({live_iters / (80 * n):.3f} of rays x 80)")


if __name__ == "__main__":
    main()
