"""Per-triangle rows shared by the rasterizer and the attribute resolve.

`build_tri_rows` packs one 64-f32 row per clipped triangle:
  [0:3]   edge a coefficients     (raster)
  [3:6]   edge b coefficients
  [6:9]   edge c constants (fill-rule biased)
  [9:12]  depth plane za zb zc
  [12]    triangle id (f32-exact)
  [13:17] coverage box x_lo x_hi y_lo y_hi (setup.TriangleSetup.box)
  [17:20] pad
  [20:23] perspective denominator plane (sum e_i / w_i)  (resolve)
  [23:50] 9 attribute/w planes x (p, q, r)
  [50]    material id
  [51:64] pad
`expand_pair_rows` gathers the raster fields [0:RASTER_ROW) once per bin pair for
the tile walk (kernel.py); `resolve_planes` gathers the resolve fields of
each pixel's winning triangle and evaluates the planes (perspective-
correct: every channel is a plane divided by the shared denominator
plane, all linear in screen x, y).
"""

from __future__ import annotations

import jax.numpy as jnp

from vkr.raster.kernel import RASTER_ROW

ROW_WIDTH = 64
RESOLVE_BASE = 20
N_CHANNELS = 9
_N_RESOLVE = 3 + 3 * N_CHANNELS + 1  # denom plane + channel planes + mat


def build_tri_rows(setup, corner_attrs=None, tri_mat=None):
    """Per-clipped-triangle 64-f32 rows (TC, 64).

    corner_attrs: optional (TC, 3, 9) per-corner attribute values; when
    None the resolve fields are zeros (visibility-only rasterization).
    """
    tc = setup.a.shape[0]
    ids = jnp.arange(tc, dtype=jnp.float32)[:, None]
    pad3 = jnp.zeros((tc, 3), jnp.float32)

    if corner_attrs is not None:
        inv_w = setup.inv_w  # (TC, 3)
        denom = jnp.stack(
            [
                (setup.a * inv_w).sum(-1),
                (setup.b * inv_w).sum(-1),
                (setup.c * inv_w).sum(-1),
            ],
            axis=-1,
        )
        aw = corner_attrs * inv_w[..., None]  # (TC, 3, 9)
        ch_p = jnp.einsum("ti,tik->tk", setup.a, aw, precision="highest")
        ch_q = jnp.einsum("ti,tik->tk", setup.b, aw, precision="highest")
        ch_r = jnp.einsum("ti,tik->tk", setup.c, aw, precision="highest")
        ch = jnp.stack([ch_p, ch_q, ch_r], axis=-1).reshape(tc, -1)
        mat = tri_mat.astype(jnp.float32)[:, None]
    else:
        denom = jnp.zeros((tc, 3), jnp.float32)
        ch = jnp.zeros((tc, 3 * N_CHANNELS), jnp.float32)
        mat = jnp.full((tc, 1), -1.0, jnp.float32)

    return jnp.concatenate(
        [
            setup.a, setup.b, setup.c, setup.zplane, ids, setup.box, pad3,
            denom, ch, mat,
            jnp.zeros((tc, ROW_WIDTH - RESOLVE_BASE - _N_RESOLVE),
                      jnp.float32),
        ],
        axis=-1,
    )


def expand_pair_rows(tri_rows, pair_tri_sorted):
    """One gather: (TC, 64) x (CAP,) -> (CAP, RASTER_ROW) pair rows.

    Dead pairs (id -1) get c = -1 edges (never cover) and id -1."""
    rows = tri_rows[jnp.maximum(pair_tri_sorted, 0), :RASTER_ROW]
    dead = jnp.zeros((RASTER_ROW,), jnp.float32)
    dead = dead.at[6:9].set(-1.0).at[12].set(-1.0)
    return jnp.where((pair_tri_sorted >= 0)[:, None], rows, dead)


def resolve_planes(tri_rows, tid, width: int, height: int, row_offset=None):
    """Per-pixel attributes of the winning triangle: (H, W, N_CHANNELS + 1)
    = [uv(2), normal(3), prev_clip(4), mat_id]. Background pixels
    (tid -1) resolve to zero channels and material -1.

    tid: (H, W) i32 clipped-triangle ids; row_offset: band row origin
    (the planes are in full-frame coordinates)."""
    r = tri_rows[jnp.maximum(tid, 0), RESOLVE_BASE:RESOLVE_BASE + _N_RESOLVE]
    fg = (tid >= 0)[..., None]
    bg = jnp.zeros((_N_RESOLVE,), jnp.float32).at[2].set(1.0).at[-1].set(
        -1.0)
    r = jnp.where(fg, r, bg)
    xs = jnp.arange(width, dtype=jnp.float32) + 0.5
    ys = jnp.arange(height, dtype=jnp.float32) + 0.5
    if row_offset is not None:
        ys = ys + jnp.asarray(row_offset, jnp.float32)
    px, py = xs[None, :], ys[:, None]
    denom = r[..., 0] * px + r[..., 1] * py + r[..., 2]
    inv_denom = 1.0 / jnp.where(jnp.abs(denom) < 1e-20, 1e-20, denom)
    chans = [(r[..., o] * px + r[..., o + 1] * py + r[..., o + 2])
             * inv_denom for o in range(3, 3 + 3 * N_CHANNELS, 3)]
    return jnp.stack(chans + [r[..., -1]], axis=-1)


# ------------------------------------------------------- SoA twins (round 5)

def corner_attributes_pre_t(attr_t, weights, n_src: int):
    """resolve.corner_attributes_pre on component-major inputs.

    attr_t: (K, 3T) static per-corner attribute table (corner-major
    columns, built at scene upload); weights: [c][m] lists of (2T,) from
    setup.clip_near_corners_t. Returns cattrs [c][k] lists of (2T,) —
    same left-associated reduction as the row-major broadcast-sum."""
    import jax.numpy as _jnp

    K = attr_t.shape[0]
    T = n_src
    from vkr.raster.setup import _sum3

    att2 = [[_jnp.concatenate([attr_t[k, m * T:(m + 1) * T]] * 2)
             for k in range(K)] for m in range(3)]
    return [[_sum3(weights[c][0] * att2[0][k],
                   weights[c][1] * att2[1][k],
                   weights[c][2] * att2[2][k])
             for k in range(K)] for c in range(3)]


def build_tri_rows_t(setup_t, cattrs, tri_mat):
    """build_tri_rows on component-major inputs: one (TC, 64) stack at
    the end instead of (TC, 3)-shaped intermediates.

    setup_t: setup.TriangleSetupT; cattrs: [c][k] lists of (TC,), or
    None for visibility only (zero resolve fields, as build_tri_rows);
    tri_mat: (TC,) int32."""
    import jax.numpy as _jnp

    a, b, c = setup_t.a, setup_t.b, setup_t.c
    iw = setup_t.inv_w
    tc = a[0].shape[0]
    ids = _jnp.arange(tc, dtype=_jnp.float32)
    zero = _jnp.zeros((tc,), _jnp.float32)

    from vkr.raster.setup import _sum3

    cols = list(a) + list(b) + list(c) + list(setup_t.zplane)
    cols += [ids] + list(setup_t.box) + [zero, zero, zero]
    if cattrs is None:
        cols += [zero] * (3 + 3 * N_CHANNELS) + [zero - 1.0]
        return _jnp.stack(cols + [zero] * (ROW_WIDTH - len(cols)), -1)
    cols += [
        _sum3(a[0] * iw[0], a[1] * iw[1], a[2] * iw[2]),
        _sum3(b[0] * iw[0], b[1] * iw[1], b[2] * iw[2]),
        _sum3(c[0] * iw[0], c[1] * iw[1], c[2] * iw[2]),
    ]
    aw = [[cattrs[i][k] * iw[i] for k in range(N_CHANNELS)]
          for i in range(3)]
    for k in range(N_CHANNELS):  # interleaved [p_k, q_k, r_k]
        cols.append(_sum3(a[0] * aw[0][k], a[1] * aw[1][k],
                          a[2] * aw[2][k]))
        cols.append(_sum3(b[0] * aw[0][k], b[1] * aw[1][k],
                          b[2] * aw[2][k]))
        cols.append(_sum3(c[0] * aw[0][k], c[1] * aw[1][k],
                          c[2] * aw[2][k]))
    cols.append(tri_mat.astype(_jnp.float32))
    cols += [zero] * (ROW_WIDTH - len(cols))
    return _jnp.stack(cols, axis=-1)
