"""Upper-bound the early-z break's pair savings on the bench camera.

For each tile: pairs whose zfloor exceeds the tile's FINAL max depth
could have been skipped by a perfect front-to-back walk. Reports the
skippable fraction of the tile kernel's per-pair walk (raster/kernel.py
tiles).

    python experiments/earlyz_potential.py
"""

from __future__ import annotations

import os
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def main():
    from vkr.core.platform import ensure_platform, pallas_interpret

    print("backend:", ensure_platform())
    import jax
    import jax.numpy as jnp
    import numpy as np

    from vkr.config import RenderConfig
    from vkr.frame import camera_frame
    from vkr.mathlib import look_at
    from vkr.passes.gbuffer import upload_scene
    from vkr.raster import setup as RS
    from vkr.raster import transform_vertices
    from vkr.raster.kernel import TILE_H, TILE_W
    from vkr.raster.pipeline import rasterize
    from vkr.scene.procedural import sponza_colonnade_scene

    W, H = 1920, 1080
    cfg = RenderConfig(width=W, height=H)
    scene = upload_scene(sponza_colonnade_scene(columns=24, tessellation=80,
                                                tex_size=64))
    view = look_at((-18, 2.2, -2), (4, 1.8, 0.5), (0, -1, 0))
    cam = camera_frame(cfg, view, view, 0)

    clip = jax.jit(lambda s: transform_vertices(
        s.positions, s.vert_transform, s.transforms, cam.mvp))(scene)
    corners, weights, src, valid = jax.jit(RS.clip_near_triangles)(
        clip, scene.tri_opaque)
    setup = jax.jit(lambda c, v: RS.triangle_setup(c, v, W, H, cam.jitter)
                    )(corners, valid)

    # min corner NDC depth per clipped triangle (the early-z sort key;
    # computed here since the production TriangleSetup dropped the field
    # when the experiment came back negative)
    wc = corners[..., 3]
    zmin_t = jnp.min(corners[..., 2] / jnp.where(
        jnp.abs(wc) < 1e-20, 1e-20, wc), axis=-1)
    tc = int(setup.a.shape[0])
    shift = max(tc, 1).bit_length()
    nb = 1 << min(16, 31 - shift)
    qz = jnp.clip((zmin_t * nb).astype(jnp.int32), 0, nb - 1)
    qz = jnp.where(setup.valid, qz, nb - 1)
    order = (jnp.sort((qz << shift) + jnp.arange(tc, dtype=jnp.int32))
             & ((1 << shift) - 1))
    zfloor = np.asarray(qz.astype(jnp.float32) / nb - 1e-4)[
        np.asarray(order)]
    bs = setup._replace(bbox=setup.bbox[order], valid=setup.valid[order])
    cap = max(int(scene.tri_opaque.shape[0] * 3.0), 4096)
    pair_tri, seg_starts, seg_counts, _ = jax.jit(
        lambda s: RS.bin_triangles(s, W, H, TILE_H, TILE_W, cap))(bs)

    vis = rasterize(clip, scene.tri_opaque, width=W, height=H,
                    jitter=cam.jitter, use_pallas=True,
                    interpret=pallas_interpret())
    depth = np.asarray(vis.depth)

    th, twl = TILE_H, TILE_W
    tiles_x = -(-W // twl)
    tiles_y = -(-H // th)
    dpad = np.pad(depth, ((0, tiles_y * th - H), (0, tiles_x * twl - W)),
                  constant_values=1.0)
    tile_zmax = dpad.reshape(tiles_y, th, tiles_x, twl).max((1, 3))

    pt = np.asarray(pair_tri)
    ss = np.asarray(seg_starts)
    sc = np.asarray(seg_counts)
    total_pairs = int(sc.sum())
    walked = 0
    for t in range(tiles_y * tiles_x):
        n = int(sc[t])
        if n == 0:
            continue
        zf = zfloor[pt[ss[t]: ss[t] + n]]
        zmax = tile_zmax[t // tiles_x, t % tiles_x]
        # a front-to-back walk stops at the first pair whose depth floor
        # lies behind everything the tile finally shows
        beyond = np.nonzero(zf > zmax)[0]
        walked += int(beyond[0]) if beyond.size else n
    skipped = total_pairs - walked
    print(f"pairs total {total_pairs} walked {walked} "
          f"skipped {skipped} ({skipped / max(total_pairs, 1):.1%})")

if __name__ == "__main__":
    main()
