"""End-to-end raster pipeline: geometry in, visibility buffer out.

Ties together transform -> near clip -> setup -> binning -> tile raster ->
attribute resolve. The analog of the reference's per-frame G-buffer draw
task (scene_renderer.cpp:140-215).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp

from vkr.raster import kernel as _kernel
from vkr.raster import pair_rows as _rows
from vkr.raster import setup as _setup
from vkr.raster.resolve import (
    corner_attributes,
    interpolate,
    pixel_barycentrics,
)


class VisibilityBuffer(NamedTuple):
    depth: jnp.ndarray      # (H, W) f32 hardware depth, 1.0 = background
    tri_id: jnp.ndarray     # (H, W) i32 clipped-triangle id, -1 = background
    setup: _setup.TriangleSetup  # clipped-triangle raster setup (TC = 2T)
    weights: jnp.ndarray    # (TC, 3, 3) near-clip corner weights
    src: jnp.ndarray        # (TC,) source triangle ids
    corners: jnp.ndarray    # (TC, 3, 4) clip-space corner positions
    overflow: jnp.ndarray   # () i32 dropped bin pairs (0 = healthy)
    # Resolved per-pixel attributes when vertex attributes were passed:
    # (H, W, N_CHANNELS + 1) = [uv(2), normal(3), prev_clip(4), mat_id].
    resolved: Optional[jnp.ndarray] = None
    # Front-end products retained for tile-walk reruns over the same
    # geometry (the alpha-MASK depth-peel pass differs from the first
    # masked pass ONLY in peel_depth). None unless keep_prepared=True.
    prepared: Optional["RasterPrepared"] = None


class RasterPrepared(NamedTuple):
    """Everything a tile walk + resolve needs, independent of peel_depth."""

    pair_rows: jnp.ndarray    # (CAP, RASTER_ROW) binned pair rows
    seg_starts: jnp.ndarray   # (n_tiles,) i32
    seg_counts: jnp.ndarray   # (n_tiles,) i32
    tri_rows: jnp.ndarray     # (TC, 64) triangle rows (resolve planes)


def _walk(prep, peel_depth, y_offset, width, height, interpret):
    zbuf, tid = _kernel.raster_tiles(
        prep.pair_rows, prep.seg_starts, prep.seg_counts, peel_depth,
        y_offset, width=width, height=height, interpret=interpret)
    return zbuf[:height, :width], tid[:height, :width]


def rasterize(
    clip,
    indices,
    *,
    width: int,
    height: int,
    pair_capacity: Optional[int] = None,
    pair_factor: float = 1.5,
    jitter=None,
    use_pallas: bool = True,
    interpret: bool = False,
    full_height: Optional[int] = None,
    y_offset=None,
    vertex_attrs=None,
    tri_mat=None,
    peel_depth=None,
    corners_t=None,
    corner_attrs_t=None,
    keep_prepared: bool = False,
    prepared: Optional["VisibilityBuffer"] = None,
) -> VisibilityBuffer:
    """Rasterize `indices` (T, 3) over clip-space positions `clip` (V, 4).

    use_pallas: True walks the binned tiles with the tile kernel
    (kernel.raster_tiles; interpret=True runs it in the Pallas
    interpreter); False runs the brute-force jnp oracle (small images).
    jitter: optional (2,) NDC offset applied to coverage only (TAA).
    full_height/y_offset: band-viewport mode (multi-chip pixel sharding).
    vertex_attrs (V, 9) + tri_mat (T,): resolve per-pixel attributes into
    VisibilityBuffer.resolved.
    pair_factor: bin-pair capacity as a multiple of the triangle count.
    With 16x16 tiles the 16 bench orbit frames peak at 1.18x T (opaque
    subset, H100 run in PERF.md); capacity-sized sort and gather work is
    the front end's cost, so keep this tight — overflow is surfaced
    loudly via VisibilityBuffer.overflow / GBuffer.overflow and fails
    the bench.
    peel_depth: optional (H, W) f32 — only fragments strictly BEHIND it
    survive (depth peeling; the alpha-MASK second-layer pass).
    corners_t (4, 3T) + corner_attrs_t (9, 3T): PRE-GATHERED per-corner
    clip positions / attribute values in component-major layout
    (corner-major columns [c*T, (c+1)*T)) — the static-scene front end
    (gbuffer.upload_scene pre-expands the shared vertex set once; the
    whole front end then runs on dense (T,) components).
    clip/indices/vertex_attrs are ignored when given.
    keep_prepared: retain the binned pair rows + segment table on the
    result so a depth-peel pass can rerun just the walk (`prepared=`).
    prepared: a prior VisibilityBuffer from the SAME geometry+camera —
    skip the whole front end and rerun only the tile walk + resolve.
    """
    if prepared is not None:
        if not use_pallas or prepared.prepared is None:
            raise ValueError(
                "prepared= rerun requires a tile-path VisibilityBuffer "
                "built with keep_prepared=True")
        prep = prepared.prepared
        zbuf, tid = _walk(prep, peel_depth, y_offset, width, height,
                          interpret)
        return prepared._replace(
            depth=zbuf, tri_id=tid, overflow=jnp.zeros((), jnp.int32),
            resolved=_rows.resolve_planes(prep.tri_rows, tid, width,
                                          height, y_offset),
            prepared=prep if keep_prepared else None)

    soa = corners_t is not None
    has_attrs = vertex_attrs is not None or corner_attrs_t is not None
    cattrs = None
    if soa:
        n_src = corners_t.shape[1] // 3
        tri2, weights_t, valid = _setup.clip_near_corners_t(
            corners_t, n_src)
        corners_c = _setup._corners_from_weights_t(tri2, weights_t)
        setup_t = _setup.triangle_setup_t(
            corners_c, valid, width, height, jitter,
            full_height=full_height, y_offset=y_offset)
        setup = setup_t.to_rowmajor()
        weights = jnp.stack(
            [jnp.stack(weights_t[c], -1) for c in range(3)], axis=1)
        corners = jnp.stack(
            [jnp.stack(corners_c[c], -1) for c in range(3)], axis=1)
        src = jnp.concatenate([jnp.arange(n_src, dtype=jnp.int32)] * 2)
        if has_attrs:
            cattrs = _rows.corner_attributes_pre_t(corner_attrs_t,
                                                   weights_t, n_src)
    else:
        corners, weights, src, valid = _setup.clip_near_triangles(
            clip, indices)
        n_src = indices.shape[0]
        setup = _setup.triangle_setup(corners, valid, width, height,
                                      jitter, full_height=full_height,
                                      y_offset=y_offset)
        if has_attrs:
            cattrs = corner_attributes(vertex_attrs, indices, weights, src)
    # src is [0..T, 0..T] by construction: stack, don't gather.
    mat2 = (jnp.concatenate([tri_mat, tri_mat], axis=0)
            if tri_mat is not None else None)

    if not use_pallas:
        zbuf, tid = _kernel.rasterize_reference(
            setup, width, height, peel_depth=peel_depth,
            row_offset=y_offset)
        resolved = None
        if has_attrs:
            if soa:  # [c][k] lists -> (TC, 3, K)
                cattrs = jnp.stack([jnp.stack(c, -1) for c in cattrs], 1)
            bary, _ = pixel_barycentrics(tid, setup, width, height,
                                         row_offset=y_offset)
            vals = interpolate(cattrs, tid, bary)
            mat = jnp.where(tid >= 0, mat2[jnp.maximum(tid, 0)], -1)
            resolved = jnp.concatenate(
                [jnp.where((tid >= 0)[..., None], vals, 0.0),
                 mat.astype(jnp.float32)[..., None]], -1)
        return VisibilityBuffer(
            depth=zbuf, tri_id=tid, setup=setup, weights=weights, src=src,
            corners=corners, overflow=jnp.zeros((), jnp.int32),
            resolved=resolved)

    if pair_capacity is None:
        # Headroom for small scenes whose few triangles span many tiles.
        tx = -(-width // _kernel.TILE_W)
        ty = -(-height // _kernel.TILE_H)
        pair_capacity = max(int(n_src * pair_factor), 4 * tx * ty, 4096)

    if soa:
        pair_tri, seg_starts, seg_counts, overflow = _setup.bin_triangles_t(
            setup_t.bbox, setup_t.valid, width, height, _kernel.TILE_H,
            _kernel.TILE_W, pair_capacity)
        tri_rows = _rows.build_tri_rows_t(setup_t, cattrs, mat2)
    else:
        pair_tri, seg_starts, seg_counts, overflow = _setup.bin_triangles(
            setup, width, height, _kernel.TILE_H, _kernel.TILE_W,
            pair_capacity)
        tri_rows = _rows.build_tri_rows(setup, cattrs, mat2)
    prep = RasterPrepared(_rows.expand_pair_rows(tri_rows, pair_tri),
                          seg_starts, seg_counts, tri_rows)
    zbuf, tid = _walk(prep, peel_depth, y_offset, width, height, interpret)
    return VisibilityBuffer(
        depth=zbuf, tri_id=tid, setup=setup, weights=weights, src=src,
        corners=corners, overflow=overflow,
        resolved=(_rows.resolve_planes(tri_rows, tid, width, height,
                                       y_offset) if has_attrs else None),
        prepared=prep if keep_prepared else None,
    )
