"""Pixel-band multi-device rendering (shard_map over framebuffer rows).

The geometry-heavy half of the frame (vertex transform, near clip,
binning, the tile raster and attribute resolve, all G-buffer texture
sampling) runs SHARDED: each device renders only its horizontal band of
rows in the band-exact viewport mode (raster/setup.py and the tile
kernel keep edge and depth planes in full-frame float coordinates, and
a triangle covers only the pixels of its full-frame bbox whatever tiles
see it), so the gathered G-buffer is bitwise the single-device one.

The bands are then all_gathered (a few MB of G-buffer planes) and the
image-space chain (SSR trace/filter/blur, probe GI, GTAO
main/filter/accumulate, shading, TAA) runs BANDED too: every expensive
pass computes only its device's rows (frame.shade_frame band mode: each
pass takes a row origin; global-access inputs like the hi-Z pyramid and
the reprojection histories stay replicated), and each pass output is
re-replicated with a tiled all_gather. hi-Z itself stays replicated: it
is cheap and the march reads it globally.

The banded frame is a different compiled program from the one-device
frame, so the compiler may round a value differently in the two (an
FMA contracted in one and not the other). The comparisons that would
turn such an ulp into a different pixel are kept out of its reach: the
SSR hash is a host-made table (ssr.halton_base_index), the stored depth
sits on a power-of-two grid (formats.quantize_d24) and the half-res
upsample uses exact products (sampling.upsample_half_bilinear). On 4
CPU devices what is left is continuous rounding noise
(tests/test_parallel.py). On four GPUs the banded frame still differs
from the one-device frame in its first-frame TAA (chip_smoke.py
--four-cards; the cause is open).

Usage mirrors render_views_sharded (sharding.py); see
__graft_entry__.dryrun_multichip and tests/test_parallel.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from vkr.passes.gbuffer import GBuffer


def render_frame_banded(
    scene,
    state,          # FrameState, full-frame (replicated)
    cam,
    ssr_res,
    cfg,
    mesh: Mesh,
    *,
    probe_grid=None,
    tri_grid=None,
    use_pallas: bool = True,
    interpret: bool = False,
):
    """One frame band-sharded over `mesh` (1-D). Returns
    (color (H, W, 3) row-sharded, new FrameState replicated, aux), the
    frame render_frame makes on one device (module docstring); aux holds
    render_frame's full-frame products (G-buffer, hi-Z depth, SSR, AO,
    overflow), replicated.

    cfg.height must divide evenly into 2x-even bands (velocity quad
    derivatives and the half-res chain need even band heights).
    """
    from vkr.core import registry
    from vkr.frame import shade_frame

    axis = mesh.axis_names[0]
    n = mesh.devices.size
    h, w = cfg.height, cfg.width
    assert h % (2 * n) == 0, (
        f"height {h} must split into even bands across {n} devices"
    )
    bh = h // n

    def per_band(scene_in, state_in, cam_in, res_in):
        band = jax.lax.axis_index(axis)
        row0 = band * bh
        gb = registry.get("gbuf_opaque_taa")(
            scene_in, cam_in.mvp, cam_in.prev_mvp, cam_in.jitter,
            width=w, height=bh, quantize=cfg.quantize_formats,
            use_pallas=use_pallas, interpret=interpret,
            mask_peel_layers=cfg.raster.mask_peel_layers,
            full_height=h, row_offset=row0,
            trilinear=cfg.trilinear_textures,
        )

        # gather the band G-buffer into the full frame (all_gather;
        # band-exact raster makes this bitwise equal to a single-device
        # G-buffer)
        def gather(x):
            return jax.lax.all_gather(x, axis, axis=0, tiled=True)

        gbuf_full = GBuffer(
            albedo=gather(gb.albedo),
            normal=gather(gb.normal),
            material=gather(gb.material),
            velocity=gather(gb.velocity),
            depth=gather(gb.depth),
            overflow=jax.lax.psum(gb.overflow, axis),
        )

        color, new_state, aux = shade_frame(
            gbuf_full, state_in, cam_in, res_in, cfg,
            probe_grid=probe_grid, tri_grid=tri_grid,
            use_pallas=use_pallas, interpret=interpret,
            band=(row0, bh), gather_fn=gather,
        )
        color_band = jax.lax.dynamic_slice(color, (row0, 0, 0),
                                           (bh, w, color.shape[-1]))
        return color_band, new_state, aux

    fn = shard_map(
        per_band,
        mesh=mesh,
        in_specs=(P(), P(), P(), P()),
        out_specs=(P(axis), P(), P()),
        check_vma=False,
    )
    return fn(scene, state, cam, ssr_res)
