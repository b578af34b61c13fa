"""SSR tile classification + per-tile plane regression.

Reference: shaders/advanced_ssr/{classification,regression,trace_indirect}
.comp (+ numpy prototype pyscript/debug_regression.py) — the indirect-
dispatch tile path that the reference constructs but leaves disabled in
AdvancedSSR::run (advanced_ssr.cpp:540-554). Array-program mapping (SURVEY.md
§7 hard part 6): the atomic-append tile lists become a dense tile-class
mask plus compacted index lists; "dispatch indirect" becomes dense masked
execution over the tile grid.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from vkr.mathlib.transforms import apply_linear
from vkr.mathlib.projection import reconstruct_view_vec

from vkr.core.registry import register

TILE = 8  # classification.comp TILE_SIZE


class TileClassification(NamedTuple):
    """classification.comp output: mirror-vs-glossy tile partition."""

    avg_roughness: jnp.ndarray     # (tiles_y, tiles_x) f32
    is_reflective: jnp.ndarray     # (tiles_y, tiles_x) bool
    reflective_tiles: jnp.ndarray  # (n_tiles,) i32 packed ids (pad -1)
    reflective_count: jnp.ndarray  # () i32
    glossy_tiles: jnp.ndarray      # (n_tiles,) i32 packed ids (pad -1)
    glossy_count: jnp.ndarray      # () i32


@register("sssr_classification")
def classify_tiles(material_full, max_roughness: float,
                   glossy_value: float) -> TileClassification:
    """Per-8x8-tile roughness vote (classification.comp): tiles whose mean
    biased roughness < glossy_value go to the reflective (mirror) list."""
    h, w = material_full.shape[:2]
    ty, tx = h // TILE, w // TILE
    rough = material_full[: ty * TILE, : tx * TILE, 1] * max_roughness
    avg = rough.reshape(ty, TILE, tx, TILE).mean(axis=(1, 3))
    is_refl = avg < glossy_value

    n_tiles = ty * tx
    ids = jnp.arange(n_tiles, dtype=jnp.int32)
    flat = is_refl.reshape(-1)
    # compact both partitions: stable sort by class puts members first
    refl_order = jnp.argsort(~flat)   # reflective (True -> ~=False) first
    glossy_order = jnp.argsort(flat)  # glossy first
    refl_count = flat.sum().astype(jnp.int32)
    glossy_count = (n_tiles - refl_count).astype(jnp.int32)
    slot = jnp.arange(n_tiles, dtype=jnp.int32)
    refl_tiles = jnp.where(slot < refl_count, ids[refl_order], -1)
    glossy_tiles = jnp.where(slot < glossy_count, ids[glossy_order], -1)
    return TileClassification(
        avg_roughness=avg,
        is_reflective=is_refl,
        reflective_tiles=refl_tiles,
        reflective_count=refl_count,
        glossy_tiles=glossy_tiles,
        glossy_count=glossy_count,
    )


@register("tile_regression")
def tile_plane_regression(depth, camera_to_world, fovy, aspect, znear,
                          zfar):
    """Per-8x8-tile least-squares plane fit (regression.comp): solve the
    3x3 normal equations for plane p with dot(p, x_i) = 1 over the tile's
    camera-relative world points; returns (tiles_y, tiles_x, 4) =
    (plane xyz, mean squared error).

    The shared-memory parallel reduction becomes a reshape-reduce; the
    3x3 inverse is closed-form adjugate (prototyped against numpy in the
    reference's pyscript/debug_regression.py)."""
    h, w = depth.shape
    ty, tx = h // TILE, w // TILE
    # NOTE: regression.comp uses uv = pixel/size (no half-texel)
    xs = jnp.arange(w, dtype=jnp.float32) / w
    ys = jnp.arange(h, dtype=jnp.float32) / h
    uv = jnp.stack(jnp.meshgrid(xs, ys), axis=-1)
    view_vec = reconstruct_view_vec(uv, depth, fovy, aspect, znear, zfar)
    m = jnp.asarray(camera_to_world)
    pts = apply_linear(view_vec, m[:3, :3])  # world_vec - world_origin

    p = pts[: ty * TILE, : tx * TILE].reshape(ty, TILE, tx, TILE, 3)

    def tsum(a):
        return a.sum(axis=(1, 3))

    s = tsum(p)                       # sum x_i
    sq = tsum(p * p)                  # sum x^2, y^2, z^2
    xy = tsum(p[..., 0:1] * p[..., 1:2])[..., 0]
    xz = tsum(p[..., 0:1] * p[..., 2:3])[..., 0]
    yz = tsum(p[..., 1:2] * p[..., 2:3])[..., 0]

    a11, a22, a33 = sq[..., 0], sq[..., 1], sq[..., 2]
    a12, a13, a23 = xy, xz, yz
    # closed-form inverse of the symmetric 3x3
    c11 = a22 * a33 - a23 * a23
    c12 = a13 * a23 - a12 * a33
    c13 = a12 * a23 - a13 * a22
    c22 = a11 * a33 - a13 * a13
    c23 = a12 * a13 - a11 * a23
    c33 = a11 * a22 - a12 * a12
    det = a11 * c11 + a12 * c12 + a13 * c13
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-20, 1e-20, det)

    bx, by, bz = s[..., 0], s[..., 1], s[..., 2]
    plane = jnp.stack(
        [
            (c11 * bx + c12 * by + c13 * bz) * inv_det,
            (c12 * bx + c22 * by + c23 * bz) * inv_det,
            (c13 * bx + c23 * by + c33 * bz) * inv_det,
        ],
        axis=-1,
    )  # (ty, tx, 3)

    err = jnp.einsum("yxc,yaxbc->yaxb", plane, p,
                     precision=jax.lax.Precision.HIGHEST) - 1.0
    err = err * err
    err = jnp.where(jnp.isnan(err), 1e10, err)
    mse = err.mean(axis=(1, 3))
    return jnp.concatenate([plane, mse[..., None]], axis=-1)


@register("sssr_trace_indirect")
def ssr_trace_indirect(hiz, normal_half, material_full, params,
                       frame_random, halton, classification,
                       reflection_type: int = 0):
    """trace_indirect.comp:44-134 — the specialized reflection trace that
    consumes the classification pass's tile lists. reflection_type 0 =
    mirror tiles (plain hierarchical_raymarch at mip 0, 50 iterations +
    a hit-depth tolerance test), 1 = glossy tiles (mip 1, 25
    iterations). Array-program mapping: "dispatch indirect over g_tiles"
    becomes dense masked execution — every pixel computes, pixels whose
    8x8 tile is not in the requested class come out invalid
    (out_ray_info = (0, 0, 1, 1), the shader's initializer). The
    reference builds this pipeline but leaves it disabled in
    AdvancedSSR::run (advanced_ssr.cpp:540-554); registered for manifest
    parity (config.json sssr_trace_indirect).

    hiz: FlatPyramid; params: SSRParams; classification: the
    sssr_classification output. Returns ray_info (h, w, 4)."""
    from vkr.passes.sampling import (
        bilinear_from_quad,
        downsample_full_to_half,
        quad_pack,
        screen_uv_grid,
    )
    from vkr.passes.ssr import _reflection_ray_setup, halton_base_index
    from vkr.passes.ssr_march import march_plain
    from vkr.mathlib.octahedral import decode_normal
    from vkr.mathlib.projection import linearize_depth

    h, w = hiz.heights[0], hiz.widths[0]
    uv = screen_uv_grid(h, w)
    size = jnp.asarray([w, h], jnp.float32)
    depth_base = hiz.flat[: h * w].reshape(h, w)

    material = downsample_full_to_half(material_full)[:h, :w]
    biased = params.max_roughness * material[..., 1]
    roughness = biased * biased

    view_vec, w0, n, r, ray_start, ray_dir = _reflection_ray_setup(
        uv, halton_base_index(h, w), depth_base, normal_half, roughness,
        params, frame_random, halton,
    )

    mirror = reflection_type == 0
    position, _hor, iters = march_plain(
        hiz, ray_start, ray_dir, view_vec, w0, params,
        max_iterations=50 if mirror else 25, find_hor=False,
        most_detailed_mip=0 if mirror else 1,
    )
    max_iters = 50 if mirror else 25
    valid_hit = iters <= max_iters

    # trace_indirect.comp:106-130 validations
    ray_step = jnp.abs(position[..., :2] - ray_start[..., :2]) * size
    valid_hit = valid_hit & (
        jnp.maximum(ray_step[..., 0], ray_step[..., 1]) >= 2.0
    )
    nm = jnp.asarray(params.normal_mat)
    hit_n_world = decode_normal(
        bilinear_from_quad(quad_pack(normal_half), 2, position[..., :2])
    )
    hit_n = apply_linear(hit_n_world, nm[:3, :3])
    valid_hit = valid_hit & ~(
        ((hit_n * r).sum(-1) > 0) | ((n * r).sum(-1) < 0)
    )
    if mirror:
        hit_depth = bilinear_from_quad(
            quad_pack(depth_base), 1, position[..., :2]
        )[..., 0]
        hit_z = linearize_depth(hit_depth, params.znear, params.zfar)
        ray_z = linearize_depth(position[..., 2], params.znear,
                                params.zfar)
        valid_hit = valid_hit & ~(
            (ray_z > hit_z + 0.3) | (ray_z < hit_z - 0.1)
        )

    in_class = trace_indirect_mask(classification, h, w)
    if reflection_type != 0:
        in_class = ~in_class
    ray_info = jnp.concatenate(
        [position, jnp.where(valid_hit, depth_base, 1.0)[..., None]], -1
    )
    untouched = jnp.broadcast_to(
        jnp.asarray([0.0, 0.0, 1.0, 1.0]), ray_info.shape
    )
    return jnp.where(in_class[..., None], ray_info, untouched)


def trace_indirect_mask(classification: TileClassification, height: int,
                        width: int):
    """The dispatch_indirect analog: a per-pixel mask of the reflective
    (mirror) tiles, for dense masked execution of the mirror-ray variant
    (trace_indirect.comp consumes the tile list; here the cheap form is
    running the trace masked to these pixels)."""
    m = classification.is_reflective
    return jnp.repeat(jnp.repeat(m, TILE, axis=0), TILE, axis=1)[
        :height, :width
    ]
