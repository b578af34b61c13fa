"""The tile rasterizer: visibility (depth + winning triangle id) per pixel.

Replaces Vulkan fixed-function rasterization (the reference's G-buffer
render pass, scene_renderer.cpp:140-215). The front end (setup.py) bins
every clipped triangle into the screen tiles its bbox touches; each tile
then walks its dense pair segment in ascending triangle order, with
LESS_OR_EQUAL depth (scene_renderer.cpp:186): the last pair in walk order
at the minimum depth wins.

Three implementations of that walk share one input layout:

  * `raster_tiles` — the GPU kernel (Pallas through Triton): one program
    per work item (a run of at most PAIRS_PER_ITEM pairs of one tile), a
    `fori_loop` over the run PAIR_CHUNK pairs at a time (their raster
    fields gathered as short vectors, every pair evaluated on every pixel
    of the tile at once), depth and winner id held in registers; the
    items of a tile are merged afterwards.
  * `raster_tiles_xla` — the plain-XLA formulation over the same binned
    pairs (each pair evaluated on its tile's pixels, then a per-tile
    segment-min of depth and segment-max of the winning id). The
    comparator the kernel is timed and checked against.
  * `rasterize_reference` — the brute-force O(T * pixels) oracle (no
    binning), for tests and the small-image parity route.

Pair rows (`pair_rows.expand_pair_rows`) are RASTER_ROW f32 each:
  [0:3] edge a   [3:6] edge b   [6:9] edge c (fill-rule biased)
  [9:12] depth plane (za, zb, zc)   [12] clipped-triangle id
  [13:17] coverage box: the first and last pixel centres of the
          triangle's bbox, x_lo x_hi y_lo y_hi (full-frame coordinates)
Attributes are resolved afterwards from the winner's triangle row
(pair_rows.resolve_planes).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

RASTER_ROW = 17
TILE_H = 16
TILE_W = 16
# Pairs evaluated together: a one-pair-at-a-time walk is a serial chain of
# dependent scalar loads (12.0 ms at bench size on the H100, PERF.md);
# a chunk issues its loads together and reduces over the chunk.
PAIR_CHUNK = 8
# Longest pair run one program walks: heavy tiles (distant, densely
# tessellated geometry) are split over several programs and merged after.
PAIRS_PER_ITEM = 128
# a (PAIR_CHUNK, 16, 16) chunk is 2048 values: 16 per thread at 4 warps
NUM_WARPS = 4
NUM_STAGES = 2


def _pixel_grid(tile_h, tile_w, ty, tx, row_offset):
    px = (jax.lax.broadcasted_iota(jnp.int32, (tile_h, tile_w), 1)
          + tx * tile_w).astype(jnp.float32) + 0.5
    py = (jax.lax.broadcasted_iota(jnp.int32, (tile_h, tile_w), 0)
          + ty * tile_h + row_offset).astype(jnp.float32) + 0.5
    return px, py


def _cover(f, px, py, zbuf, peel):
    """Coverage + depth of one pair row over a pixel block. f(k) reads
    field k of the row (scalar or broadcastable)."""
    e0 = f(0) * px + f(3) * py + f(6)
    e1 = f(1) * px + f(4) * py + f(7)
    e2 = f(2) * px + f(5) * py + f(8)
    d = f(9) * px + f(10) * py + f(11)
    cover = ((e0 >= 0.0) & (e1 >= 0.0) & (e2 >= 0.0)
             & (px >= f(13)) & (px <= f(14)) & (py >= f(15))
             & (py <= f(16))
             & (d >= 0.0) & (d <= 1.0) & (d <= zbuf) & (d > peel))
    return cover, d


def _tile_kernel(item_tile_ref, item_start_ref, item_count_ref, yoff_ref,
                 rows_ref, peel_ref, z_ref, tid_ref, *, tile_h, tile_w,
                 tiles_x, n_rows):
    item = pl.program_id(0)
    tile = item_tile_ref[item]
    start = item_start_ref[item]
    count = item_count_ref[item]
    ty = tile // tiles_x
    tx = tile - ty * tiles_x
    px, py = _pixel_grid(tile_h, tile_w, ty, tx, yoff_ref[0])
    peel = peel_ref[pl.ds(ty * tile_h, tile_h), pl.ds(tx * tile_w, tile_w)]
    px, py, peel = px[None], py[None], peel[None]
    lane = jax.lax.broadcasted_iota(jnp.int32, (PAIR_CHUNK,), 0)

    def body(c, carry):
        zbuf, win = carry
        k0 = c * PAIR_CHUNK + lane
        rows = jnp.minimum(start + k0, n_rows - 1)

        def f(k):
            return rows_ref[rows, k][:, None, None]

        cover, d = _cover(f, px, py, zbuf[None], peel)
        cover = cover & (k0 < count)[:, None, None]
        dz = jnp.where(cover, d, jnp.inf)
        zc = jnp.min(dz, axis=0)
        # the LAST pair at the chunk's minimum wins (LESS_OR_EQUAL walk)
        idc = jnp.max(jnp.where(cover & (dz == zc[None]), f(12), -1.0),
                      axis=0)
        take = zc <= zbuf
        return jnp.where(take, zc, zbuf), jnp.where(take, idc, win)

    zbuf, win = jax.lax.fori_loop(
        0, (count + PAIR_CHUNK - 1) // PAIR_CHUNK, body,
        (jnp.ones((tile_h, tile_w), jnp.float32),
         jnp.full((tile_h, tile_w), -1.0, jnp.float32)))
    z_ref[...] = zbuf
    tid_ref[...] = win


def work_items(seg_starts, seg_counts, n_items: int):
    """Split every tile's segment into items of at most PAIRS_PER_ITEM
    pairs (at least one item per tile), so a tile of thousands of small
    triangles spreads over many programs. Returns (tile, start, count)
    per item, (n_items,) i32 each; unused items have count 0 and tile
    n_tiles."""
    n_tiles = seg_counts.shape[0]
    per_tile = jnp.maximum(-(-seg_counts // PAIRS_PER_ITEM), 1)
    first = jnp.cumsum(per_tile) - per_tile
    tile = jnp.repeat(jnp.arange(n_tiles, dtype=jnp.int32), per_tile,
                      total_repeat_length=n_items)
    ids = jnp.arange(n_items, dtype=jnp.int32)
    used = ids < first[-1] + per_tile[-1]
    part = ids - first[tile]
    start = seg_starts[tile] + part * PAIRS_PER_ITEM
    count = jnp.clip(seg_counts[tile] - part * PAIRS_PER_ITEM, 0,
                     PAIRS_PER_ITEM)
    return (jnp.where(used, tile, n_tiles), start,
            jnp.where(used, count, 0))


def _padded(width, height, tile_h, tile_w):
    tiles_x = -(-width // tile_w)
    tiles_y = -(-height // tile_h)
    return tiles_x, tiles_y, tiles_y * tile_h, tiles_x * tile_w


def pad_peel(peel_depth, width, height, tile_h=TILE_H, tile_w=TILE_W):
    """(H, W) peel floor -> tile-padded (H', W'); None -> all -1 (no
    peeling). Padding pixels never survive (they are cropped anyway)."""
    _, _, hp, wp = _padded(width, height, tile_h, tile_w)
    if peel_depth is None:
        return jnp.full((hp, wp), -1.0, jnp.float32)
    return jnp.pad(peel_depth, ((0, hp - peel_depth.shape[0]),
                                (0, wp - peel_depth.shape[1])),
                   constant_values=-1.0)


def _row_offset(row_offset):
    if row_offset is None:
        return jnp.zeros((1,), jnp.int32)
    return jnp.asarray(row_offset, jnp.int32).reshape(1)


@functools.partial(
    jax.jit,
    static_argnames=("width", "height", "tile_h", "tile_w", "interpret"),
)
def raster_tiles(rows, seg_starts, seg_counts, peel_depth=None,
                 row_offset=None, *, width: int, height: int,
                 tile_h: int = TILE_H, tile_w: int = TILE_W,
                 interpret: bool = False):
    """Walk every tile's pair segment (the GPU kernel).

    rows: (n_pairs, RASTER_ROW) f32 pair rows in segment order;
    seg_starts/seg_counts: (n_tiles,) i32 (setup.bin_triangles);
    peel_depth: optional (H, W) f32 — only fragments strictly behind it
    survive (alpha-MASK depth peeling); row_offset: optional () i32 band
    row origin (band-exact viewports: pixel rows are full-frame).

    Returns (depth (H', W') f32, tri_id (H', W') i32) at tile-padded size
    (crop to (height, width))."""
    tiles_x, tiles_y, hp, wp = _padded(width, height, tile_h, tile_w)
    n_tiles = tiles_x * tiles_y
    n_items = n_tiles + -(-rows.shape[0] // PAIRS_PER_ITEM)
    tile, start, count = work_items(seg_starts, seg_counts, n_items)
    peel = pad_peel(peel_depth, width, height, tile_h, tile_w)
    item_spec = pl.BlockSpec((tile_h, tile_w), lambda i: (i, 0))
    whole = pl.BlockSpec(memory_space=pl.ANY)
    kernel = functools.partial(_tile_kernel, tile_h=tile_h, tile_w=tile_w,
                               tiles_x=tiles_x, n_rows=rows.shape[0])
    z, win = pl.pallas_call(
        kernel,
        grid=(n_items,),
        in_specs=[whole] * 6,
        out_specs=[item_spec, item_spec],
        out_shape=[jax.ShapeDtypeStruct((n_items * tile_h, tile_w),
                                        jnp.float32)] * 2,
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=NUM_STAGES),
        interpret=interpret,
        name="raster_tiles",
    )(jnp.minimum(tile, n_tiles - 1), start, count,
      _row_offset(row_offset), rows, peel)

    # merge the items of each tile: nearest depth, then the last pair
    # (largest id: later items hold later pairs) at that depth
    z = z.reshape(n_items, tile_h * tile_w)
    win = win.reshape(n_items, tile_h * tile_w)
    zmin = jnp.full((n_tiles, tile_h * tile_w), jnp.inf, jnp.float32).at[
        tile].min(z, mode="drop")
    hit = (z == zmin[jnp.minimum(tile, n_tiles - 1)]) & (win >= 0)
    best = jnp.full((n_tiles, tile_h * tile_w), -1.0, jnp.float32).at[
        tile].max(jnp.where(hit, win, -1.0), mode="drop")
    return (_tiles_to_image(jnp.where(best >= 0, zmin, 1.0), tiles_x,
                            tiles_y, tile_h, tile_w),
            _tiles_to_image(best, tiles_x, tiles_y, tile_h,
                            tile_w).astype(jnp.int32))


def _tiles_to_image(a, tiles_x, tiles_y, tile_h, tile_w):
    """(n_tiles, tile_h * tile_w) tile-major -> (H', W') image."""
    return a.reshape(tiles_y, tiles_x, tile_h, tile_w).transpose(
        0, 2, 1, 3).reshape(tiles_y * tile_h, tiles_x * tile_w)


@functools.partial(
    jax.jit, static_argnames=("width", "height", "tile_h", "tile_w"))
def raster_tiles_xla(rows, seg_starts, seg_counts, peel_depth=None,
                     row_offset=None, *, width: int, height: int,
                     tile_h: int = TILE_H, tile_w: int = TILE_W):
    """raster_tiles as plain XLA over the same binned pairs: every pair
    is evaluated once on its own tile's pixels, depth reduced with a
    per-tile scatter-min, then the winner (the LAST pair in walk order at
    that depth = the largest triangle id, since segments ascend by id)
    with a scatter-max over the pairs that hit the minimum. The (pairs,
    tile pixels) depth candidates are materialized once, so both
    reductions see bit-identical values. Same inputs and outputs as
    raster_tiles."""
    tiles_x, tiles_y, hp, wp = _padded(width, height, tile_h, tile_w)
    n_tiles = tiles_x * tiles_y
    n = rows.shape[0]
    live = jnp.arange(n) < (seg_starts[-1] + seg_counts[-1])
    tile_of = jnp.repeat(jnp.arange(n_tiles, dtype=jnp.int32), seg_counts,
                         total_repeat_length=n)
    tile = jnp.where(live, tile_of, 0)
    peel = pad_peel(peel_depth, width, height, tile_h, tile_w).reshape(
        tiles_y, tile_h, tiles_x, tile_w).transpose(0, 2, 1, 3).reshape(
        n_tiles, tile_h * tile_w)
    yoff = _row_offset(row_offset)[0]

    shape = (n, tile_h, tile_w)
    px = (jnp.arange(tile_w)[None, None, :]
          + (tile % tiles_x)[:, None, None] * tile_w)
    py = (jnp.arange(tile_h)[None, :, None]
          + (tile // tiles_x)[:, None, None] * tile_h + yoff)
    px = jnp.broadcast_to(px.astype(jnp.float32) + 0.5, shape).reshape(n, -1)
    py = jnp.broadcast_to(py.astype(jnp.float32) + 0.5, shape).reshape(n, -1)
    cover, d = _cover(lambda k: rows[:, k:k + 1], px, py, 1.0, peel[tile])
    dval = jnp.where(cover & live[:, None], d, jnp.inf)

    zmin = jnp.full((n_tiles, tile_h * tile_w), jnp.inf,
                    jnp.float32).at[tile].min(dval)
    hit = (dval == zmin[tile]) & (dval < jnp.inf)
    win = jnp.full((n_tiles, tile_h * tile_w), -1.0, jnp.float32).at[
        tile].max(jnp.where(hit, rows[:, 12:13], -1.0))

    depth = jnp.where(win >= 0, zmin, 1.0)
    return (_tiles_to_image(depth, tiles_x, tiles_y, tile_h, tile_w),
            _tiles_to_image(win, tiles_x, tiles_y, tile_h,
                            tile_w).astype(jnp.int32))


def rasterize_reference(setup, width: int, height: int, peel_depth=None,
                        row_offset=None):
    """Brute-force jnp rasterizer (no binning): the correctness oracle,
    usable on any backend. O(T * pixels) — small scenes and tests only.
    peel_depth: depth-peeling floor (see pipeline); row_offset:
    band-exact viewport row origin."""
    xs = jnp.arange(width, dtype=jnp.float32) + 0.5
    ys = jnp.arange(height, dtype=jnp.float32) + 0.5
    if row_offset is not None:
        ys = ys + jnp.asarray(row_offset, jnp.float32)
    px = xs[None, :]
    py = ys[:, None]

    n_tri = setup.a.shape[0]
    zbuf = jnp.ones((height, width), jnp.float32)
    tid = jnp.full((height, width), -1, jnp.int32)
    peel = (jnp.full((height, width), -1.0, jnp.float32)
            if peel_depth is None else peel_depth)

    def body(i, carry):
        zbuf, tid = carry
        a, b, c = setup.a[i], setup.b[i], setup.c[i]
        zp = setup.zplane[i]
        row = jnp.concatenate([a, b, c, zp, jnp.zeros((1,)),
                               setup.box[i]])
        cover, d = _cover(lambda k: row[k], px, py, zbuf, peel)
        cover = cover & setup.valid[i]
        return jnp.where(cover, d, zbuf), jnp.where(cover, i, tid)

    return jax.lax.fori_loop(0, n_tri, body, (zbuf, tid))
