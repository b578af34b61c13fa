"""Deferred attribute resolve of the oracle raster route.

The rasterizer records which triangle won each pixel. Here the oracle
route (pipeline.rasterize with use_pallas=False) recomputes
perspective-correct barycentrics per pixel from the winner's edge
equations and interpolates vertex attributes (the work the reference's
fragment shader gets from the hardware interpolators,
gbuf/opaque_taa.frag) — independent of the tile route's plane replay
(pair_rows.resolve_planes), which the tests compare it against.
"""

from __future__ import annotations

import jax.numpy as jnp


def corner_attributes(vertex_attr, indices, weights, src):
    """Vertex attribute array (V, K) -> per-clipped-triangle corner values
    (TC, 3, K), applying the near-clip interpolation weights
    (setup.clip_near_triangles)."""
    tri_attr = vertex_attr[indices[src]]  # (TC, 3 src corners, K)
    # broadcast-sum instead of einsum: exact f32 and fused elementwise
    return (weights[..., :, None] * tri_attr[:, None, :, :]).sum(2)


def corner_attributes_pre(corner_attr, weights):
    """corner_attributes for PRE-GATHERED per-triangle corner values.

    corner_attr: (T, 3, K) attribute values at each source triangle's own
    corners (built once at scene upload — no per-frame `vertex_attr[
    indices]` gather). clip_near_corners
    emits exactly two clipped triangles per source triangle in source
    order, so `indices[src]`-gathered rows are just the table stacked
    twice — a concatenate, not a gather.
    """
    tri_attr = jnp.concatenate([corner_attr, corner_attr], axis=0)
    return (weights[..., :, None] * tri_attr[:, None, :, :]).sum(2)


def pixel_barycentrics(tid, setup, width: int, height: int,
                       row_offset=None):
    """Perspective-correct barycentrics for each pixel's winning triangle.

    tid: (H, W) int32 visibility buffer (-1 = background).
    row_offset: band-viewport row origin — the edge planes are in
    FULL-frame coordinates (band-exact mode), so band pixels must be
    evaluated at their global rows.
    Returns (bary (H, W, 3) f32, mask (H, W) bool).
    """
    t = jnp.maximum(tid, 0)
    mask = tid >= 0

    xs = jnp.arange(width, dtype=jnp.float32) + 0.5
    ys = jnp.arange(height, dtype=jnp.float32) + 0.5
    if row_offset is not None:
        ys = ys + jnp.asarray(row_offset, jnp.float32)
    px = xs[None, :, None]
    py = ys[:, None, None]

    a = setup.a[t]  # (H, W, 3)
    b = setup.b[t]
    c = setup.c[t]
    inv_w = setup.inv_w[t]

    e = a * px + b * py + c  # (H, W, 3) screen-space edge values
    e = jnp.maximum(e, 0.0)  # guard the fill-rule bias at edges
    sb = e / jnp.maximum(e.sum(-1, keepdims=True), 1e-20)
    q = sb * inv_w
    bary = q / jnp.maximum(q.sum(-1, keepdims=True), 1e-20)
    return bary, mask


def interpolate(corner_attr, tid, bary):
    """corner_attr: (TC, 3, K); tid: (H, W); bary: (H, W, 3) ->
    (H, W, K)."""
    t = jnp.maximum(tid, 0)
    vals = corner_attr[t]  # (H, W, 3, K)
    return jnp.einsum("hwc,hwck->hwk", bary, vals, precision="highest")
