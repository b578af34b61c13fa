"""Quantify the alpha-MASK depth-peel cap on the bench scene.

The reference alpha-tests EVERY masked fragment in depth order
(per-fragment discard, shaders/gbuf/opaque_taa.frag:32-44 — arbitrary
overlap depth). Our raster peels at most `mask_peel_layers` masked
layers (passes/gbuffer.py). This harness builds the ORACLE winner by
peeling until no alpha-discarded pixel remains (or K layers), then
reports how many pixels the cap=1 and cap=2 composites get wrong on the
real bench workload (scene + all 16 orbit cameras), plus the albedo
PSNR delta — the number PARITY.md's deviation row should carry.

    python experiments/mask_peel_oracle.py
"""

from __future__ import annotations

import os
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def main():
    from vkr.core.platform import ensure_platform, pallas_interpret

    backend = ensure_platform()
    print("backend:", backend, flush=True)
    interp = pallas_interpret()
    import jax
    import jax.numpy as jnp
    import numpy as np

    from bench import bench_orbit_view
    from vkr.config import RenderConfig
    from vkr.frame import camera_frame
    from vkr.passes.gbuffer import (DEFAULT_ALBEDO, _lod_for,
                                        _resolve_attrs, upload_scene)
    from vkr.raster import (rasterize, transform_normals,
                                transform_vertices)
    from vkr.raster.texture import sample_alpha_sparse, small_lookup
    from vkr.scene.procedural import sponza_colonnade_scene

    W, H = (int(x) for x in
            os.environ.get("PEEL_RES", "1920x1080").split("x"))
    n_frames = int(os.environ.get("PEEL_FRAMES", "16"))
    K = 6  # oracle peel depth (bench foliage stacks measured <= 4 deep)
    cfg = RenderConfig(width=W, height=H)
    scene = upload_scene(sponza_colonnade_scene(
        columns=24, tessellation=80, tex_size=64))

    def layers(scene, mvp, jitter):
        """Front-to-back masked layers: per-layer (hit, alpha-pass,
        depth, mat, uv), peeling where the PREVIOUS layer exists."""
        clip = transform_vertices(scene.positions, scene.vert_transform,
                                  scene.transforms, mvp)
        world_n = transform_normals(scene.normals, scene.vert_transform,
                                    scene.normal_mats)
        vattrs = jnp.concatenate(
            [scene.uvs, world_n, jnp.zeros_like(clip)], axis=-1)
        rkw = dict(width=W, height=H, jitter=jitter, use_pallas=True,
                   interpret=interp, vertex_attrs=vattrs)
        vis_o = rasterize(clip, scene.tri_opaque,
                          tri_mat=scene.tri_opaque_mat, **rkw)
        out = []
        peel = None
        for _ in range(K):
            vis = rasterize(clip, scene.tri_masked,
                            tri_mat=scene.tri_masked_mat,
                            peel_depth=peel, **rkw)
            attrs = _resolve_attrs(vis)
            hit = vis.tri_id >= 0
            aidx = small_lookup(scene.mat_albedo_tex,
                                jnp.maximum(attrs["mat_id"], 0))
            lod = _lod_for(scene.tex, attrs["uv"], aidx)
            alpha = jnp.where(
                aidx >= 0,
                sample_alpha_sparse(scene.tex, jnp.maximum(aidx, 0),
                                    attrs["uv"], lod, hit & (aidx >= 0)),
                DEFAULT_ALBEDO[3])
            out.append((hit, hit & (alpha != 0.0), vis.depth,
                        attrs["mat_id"], attrs["uv"]))
            peel = vis.depth
        return out, vis_o.depth

    def winners(ls, opaque_depth, cap):
        """Composite winner (exists, depth, mat, uv) under a layer cap:
        first alpha-passing layer in front of the opaque surface."""
        exists = jnp.zeros(opaque_depth.shape, bool)
        depth = jnp.ones_like(opaque_depth)
        mat = jnp.full(opaque_depth.shape, -1.0)
        uv = jnp.zeros(opaque_depth.shape + (2,))
        blocked = jnp.zeros(opaque_depth.shape, bool)  # settled earlier
        for hit, keep, d, m, u in ls[:cap]:
            win = ~blocked & keep & (d <= opaque_depth)
            exists = exists | win
            depth = jnp.where(win, d, depth)
            mat = jnp.where(win, m, mat)
            uv = jnp.where(win[..., None], u, uv)
            # an alpha-PASSING layer settles the pixel either way; a
            # miss (no fragment) means no deeper fragment exists either
            blocked = blocked | keep | ~hit
        return exists, depth, mat, uv

    f = jax.jit(lambda s, mvp, j: layers(s, mvp, j))
    tot = {1: 0, 2: 0}
    tot_cov = 0
    tot_deep = 0
    se = {1: 0.0, 2: 0.0}
    n_alb = 0
    for i in range(n_frames):
        view = bench_orbit_view(i)
        cam = camera_frame(cfg, view, view, i)
        ls, od = f(scene, cam.mvp, cam.jitter)
        oracle = winners(ls, od, K)
        caps = {c: winners(ls, od, c) for c in (1, 2)}
        # pixels still unresolved after the oracle's K layers (should
        # be ~0; otherwise K needs raising)
        h0 = np.asarray(ls[0][0])
        cov = int(h0.sum())
        tot_cov += cov
        ex_o, d_o, m_o, uv_o = (np.asarray(x) for x in oracle)
        # depth of the masked stack: first layer hit but its keep-chain
        # exhausts >= 3 layers before settling
        deep = np.asarray(ls[2][0])  # a 3rd masked fragment exists
        tot_deep += int(deep.sum())
        for c in (1, 2):
            ex_c, d_c, m_c, uv_c = (np.asarray(x) for x in caps[c])
            diff = (ex_c != ex_o) | (ex_o & ((m_c != m_o)
                                             | (d_c != d_o)))
            tot[c] += int(diff.sum())
            # albedo proxy PSNR: uv+mat drive the albedo fetch; score
            # the winner mismatch as full-scale error on those pixels
            se[c] += float(diff.sum())
        n_alb += h0.size
    print(f"frames {n_frames}, {W}x{H}: masked-covered px {tot_cov} "
          f"({tot_cov / n_alb:.3%} of frame)")
    print(f"pixels with a 3rd masked fragment: {tot_deep} "
          f"({tot_deep / n_alb:.4%})")
    for c in (1, 2):
        frac = tot[c] / n_alb
        psnr = (10.0 * np.log10(1.0 / max(frac, 1e-12))
                if frac > 0 else float("inf"))
        print(f"cap={c}: wrong-winner px {tot[c]} ({frac:.5%} of frame)"
              f" -> worst-case albedo PSNR {psnr:.1f} dB")


if __name__ == "__main__":
    main()
