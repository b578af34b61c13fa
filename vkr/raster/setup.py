"""Rasterizer front end: vertex transform, triangle setup, tile binning.

Replaces the Vulkan fixed-function vertex/raster stages driven by the
reference's G-buffer pass (scene_renderer.cpp:140-215 + gbuf/opaque_taa.vert).
All of this is dense jnp — vertex transforms are full-precision matmuls,
binning is cumsum/sort dataflow — and feeds the tile kernel (kernel.py).

Conventions (matching the reference):
  * clip space: Vulkan, depth in [0,1], y-down NDC; clip = VP @ model @ pos
  * jitter: added to clip xy scaled by w (opaque_taa.vert:40)
  * screen: pixel centers at (x+0.5, y+0.5), uv = ((x+.5)/W, (y+.5)/H)
  * fill rule: top-left (Vulkan), two-sided (cull NONE, pipelines.hpp:113)
  * depth test: LESS_OR_EQUAL against cleared 1.0 (scene_renderer.cpp:186)
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class TriangleSetup(NamedTuple):
    """Per-triangle raster data, orientation-normalized (interior => e >= 0).

    Edge i is opposite vertex i; e_i(x, y) = a_i x + b_i y + c_i, and the
    unnormalized barycentric of vertex i is e_i / area. Depth is the screen-
    space-linear NDC z plane: d(x, y) = za x + zb y + zc.
    """

    a: jnp.ndarray      # (T, 3) edge x-coefficients
    b: jnp.ndarray      # (T, 3) edge y-coefficients
    c: jnp.ndarray      # (T, 3) edge constants (fill-rule bias applied)
    zplane: jnp.ndarray  # (T, 3) [za, zb, zc]
    inv_area: jnp.ndarray  # (T,) 1 / normalized area (for barycentrics)
    inv_w: jnp.ndarray  # (T, 3) 1 / clip w per corner (perspective correct)
    valid: jnp.ndarray  # (T,) bool — survives face/frustum rejection
    bbox: jnp.ndarray   # (T, 4) int32 [x0, y0, x1, y1] pixel bbox (inclusive)
    # (T, 4) f32 [x_lo, x_hi, y_lo, y_hi]: the bbox's first and last pixel
    # centres in full-frame coordinates. Coverage is limited to it, as in a
    # hardware bbox scan: far from a sliver its edge functions lose their
    # sign, and which tiles see it must not change what it covers.
    box: jnp.ndarray


def transform_vertices(positions, transform_ids, transforms, view_proj):
    """Model -> clip transform for all vertices at once.

    positions: (V, 3); transform_ids: (V,) int32 into transforms (N, 4, 4);
    view_proj: (4, 4). Returns clip positions (V, 4).

    Equivalent of opaque_taa.vert:38 (view_projection * model * pos) with the
    per-node transform SSBO (scene_renderer.cpp:121-131) becoming a gathered
    matrix table.
    """
    mats = transforms[transform_ids]  # (V, 4, 4)
    pos_h = jnp.concatenate(
        [positions, jnp.ones((*positions.shape[:-1], 1), positions.dtype)],
        axis=-1,
    )
    world = jnp.einsum("vij,vj->vi", mats, pos_h, precision="highest")
    return jnp.matmul(world, view_proj.T, precision="highest")


def transform_normals(normals, transform_ids, normal_mats):
    """World-space normals via the per-node normal matrix
    (opaque_taa.vert:36)."""
    mats = normal_mats[transform_ids]  # (V, 4, 4)
    n = jnp.einsum("vij,vj->vi", mats[:, :3, :3], normals, precision="highest")
    return n / jnp.linalg.norm(n, axis=-1, keepdims=True).clip(1e-20)


def clip_near_triangles(clip, indices):
    """Near-plane clipping from a shared vertex set: gathers the corner
    positions (the generic path) and defers to clip_near_corners.

    Static scenes pre-gather world-space corners at upload
    (gbuffer.upload_scene) and enter via clip_near_corners directly —
    gathering commutes with the row-wise view-projection matmul, so both
    routes are bitwise identical.
    """
    return clip_near_corners(clip[indices])


def clip_near_corners(tri):
    """Near-plane (z=0) clipping: every input triangle yields up to two
    output triangles with all vertices at z >= 0.

    Vulkan clips primitives against z=0 (depth-zero-to-one); doing it here
    keeps the downstream raster math free of w<=0 poles. Input is the
    per-triangle corner positions (T, 3, 4) in clip space. Output is a new
    vertex set: corner positions per output triangle (2T, 3, 4) plus
    interpolation weights (2T, 3, 3) expressing each output corner as a
    convex combination of the source triangle's corners (used later to
    interpolate attributes of clipped corners), plus the source triangle id
    (2T,) and validity mask (2T,).
    """
    z = tri[..., 2]
    inside = z >= 0.0  # (T, 3)
    n_inside = inside.sum(axis=-1)  # (T,)

    # Rotate corners so that "inside" vertices come first, preserving
    # winding (cyclic rotation only).  rot = index of first inside vertex in
    # the canonical pattern for each case.
    #   n=3: rot 0.  n=0: dropped.
    #   n=1: rotate so the single inside vertex is corner 0.
    #   n=2: rotate so the single OUTSIDE vertex is corner 2.
    i0, i1, i2 = inside[:, 0], inside[:, 1], inside[:, 2]
    rot_one = jnp.where(i0, 0, jnp.where(i1, 1, 2))
    rot_two = jnp.where(~i0, 1, jnp.where(~i1, 2, 0))
    rot = jnp.where(n_inside == 1, rot_one, rot_two)  # (T,)

    # Cyclic rotation as select chains (2 selects per corner).
    def _cyc(a, i):
        """a[:, (rot + i) % 3] for a (T, 3, ...)."""
        r = rot.reshape(rot.shape + (1,) * (a.ndim - 2))
        return jnp.where(
            r == 0, a[:, i % 3],
            jnp.where(r == 1, a[:, (i + 1) % 3], a[:, (i + 2) % 3]),
        )

    tri_r = jnp.stack([_cyc(tri, i) for i in range(3)], axis=1)
    zr = tri_r[..., 2]

    def lerp_t(za, zb):
        # Intersection parameter of segment a->b with z=0.
        return za / jnp.where(jnp.abs(za - zb) < 1e-20, 1e-20, za - zb)

    # Case n=1: inside A, outside B, C. New triangle: A, AB(t01), AC(t02).
    # Case n=2: inside A, B, outside C. Quad A, B, BC(t12), AC(t02) -> two
    # triangles (A, B, BC) and (A, BC, AC).
    t01 = lerp_t(zr[:, 0], zr[:, 1])
    t12 = lerp_t(zr[:, 1], zr[:, 2])
    t02 = lerp_t(zr[:, 0], zr[:, 2])

    def mix(wa, wb, t):
        return (1.0 - t[:, None]) * wa + t[:, None] * wb

    eye = jnp.eye(3, dtype=tri.dtype)
    wA = jnp.broadcast_to(eye[0], (tri.shape[0], 3))
    wB = jnp.broadcast_to(eye[1], (tri.shape[0], 3))
    wC = jnp.broadcast_to(eye[2], (tri.shape[0], 3))
    wAB = mix(wA, wB, t01)
    wBC = mix(wB, wC, t12)
    wAC = mix(wA, wC, t02)

    # First output triangle per case (weights in rotated corner space):
    #   n=3 -> (A, B, C); n=1 -> (A, AB, AC); n=2 -> (A, B, BC)
    w1 = jnp.where(
        (n_inside == 3)[:, None, None],
        jnp.stack([wA, wB, wC], axis=1),
        jnp.where(
            (n_inside == 1)[:, None, None],
            jnp.stack([wA, wAB, wAC], axis=1),
            jnp.stack([wA, wB, wBC], axis=1),
        ),
    )  # (T, 3 corners, 3 weights)
    # Second output triangle: only for n=2 -> (A, BC, AC)
    w2 = jnp.stack([wA, wBC, wAC], axis=1)
    valid1 = n_inside >= 1
    valid2 = n_inside == 2

    # Un-rotate weights back to original corner order: weight j of the
    # rotated corner applies to original corner (rot + j) % 3, i.e.
    # out[:, c, k] = w[:, c, (k - rot) % 3] — select chains again.
    def unrotate(w):
        r = rot[:, None]
        cols = []
        for k in range(3):
            cols.append(jnp.where(
                r == 0, w[..., k % 3],
                jnp.where(r == 1, w[..., (k - 1) % 3],
                          w[..., (k - 2) % 3]),
            ))
        return jnp.stack(cols, axis=-1)

    w1 = unrotate(w1)
    w2 = unrotate(w2)

    weights = jnp.concatenate([w1, w2], axis=0)  # (2T, 3, 3)
    src = jnp.concatenate([jnp.arange(tri.shape[0])] * 2, axis=0)
    valid = jnp.concatenate([valid1, valid2], axis=0)
    tri2 = jnp.concatenate([tri, tri], axis=0)
    # broadcast-sum (see resolve.corner_attributes for the rationale)
    corners = (weights[..., :, None] * tri2[:, None, :, :]).sum(2)
    return corners, weights, src, valid


_FILL_EPS = 1.0 / 4096.0  # sub-pixel bias excluding non-top-left edges


def triangle_setup(
    corners, valid, width: int, height: int, jitter=None,
    full_height: int | None = None, y_offset=None,
) -> TriangleSetup:
    """Build edge equations from clipped corner positions (T, 3, 4).

    Applies the TAA jitter to raster coverage only (the reference adds
    jitter to gl_Position but passes unjittered clip down for velocity,
    opaque_taa.vert:40-43).

    full_height/y_offset: band-viewport rendering for multi-chip
    pixel-band sharding (parallel/sharding.py). BAND-EXACT: the edge /
    depth-plane coefficients stay in FULL-frame coordinates (bitwise
    identical to the full-frame setup — no float translation); only the
    integer pixel bbox is windowed to the band, and the raster kernel
    offsets its pixel rows by y_offset (kernel.py row_offset).
    """
    w = corners[..., 3]
    inv_w = 1.0 / jnp.where(jnp.abs(w) < 1e-20, 1e-20, w)
    ndc = corners[..., :3] * inv_w[..., None]
    if jitter is not None:
        ndc = ndc.at[..., :2].add(jnp.asarray(jitter)[None, None, :])

    x = (ndc[..., 0] * 0.5 + 0.5) * width   # (T, 3)
    y = (ndc[..., 1] * 0.5 + 0.5) * (full_height or height)
    d = ndc[..., 2]
    y_off = 0 if y_offset is None else y_offset

    # Signed doubled area; orientation-normalize (two-sided raster).
    area = (x[:, 1] - x[:, 0]) * (y[:, 2] - y[:, 0]) - (
        y[:, 1] - y[:, 0]
    ) * (x[:, 2] - x[:, 0])
    s = jnp.where(area >= 0.0, 1.0, -1.0)
    abs_area = jnp.abs(area)
    ok = valid & (abs_area > 1e-12)

    # Edge i opposite corner i: from corner j to corner k, (i,j,k) cyclic.
    j = jnp.array([1, 2, 0])
    k = jnp.array([2, 0, 1])
    xj, yj = x[:, j], y[:, j]
    xk, yk = x[:, k], y[:, k]
    a = -(yk - yj) * s[:, None]
    b = (xk - xj) * s[:, None]
    c = ((yk - yj) * xj - (xk - xj) * yj) * s[:, None]

    # Vulkan top-left fill rule (y-down): an edge is inclusive iff it is a
    # left edge (a > 0) or a top edge (a == 0 and b > 0); others get a
    # negative bias so exact-on-edge pixel centers are excluded.
    inclusive = (a > 0.0) | ((a == 0.0) & (b > 0.0))
    edge_len = jnp.sqrt(a * a + b * b)
    c = jnp.where(inclusive, c, c - _FILL_EPS * edge_len)

    # Screen-linear NDC depth plane from barycentric identity.
    inv_area = 1.0 / jnp.where(abs_area < 1e-20, 1e-20, abs_area)
    za = jnp.sum(a * d, axis=-1) * inv_area
    zb = jnp.sum(b * d, axis=-1) * inv_area
    zc = jnp.sum(c * d, axis=-1) * inv_area
    # NOTE: c was biased after-the-fact; rebuild zc from unbiased constants
    c_unbiased = ((yk - yj) * xj - (xk - xj) * yj) * s[:, None]
    zc = jnp.sum(c_unbiased * d, axis=-1) * inv_area

    # Pixel bbox (inclusive), clamped to the band viewport; bbox rows are
    # stored band-relative (integer subtraction — exact) so binning and
    # the kernels work in local tiles while the float coefficients stay
    # global.
    fh = full_height or height
    x0 = jnp.clip(jnp.floor(jnp.min(x, axis=-1) - 0.5), 0, width - 1)
    x1 = jnp.clip(jnp.ceil(jnp.max(x, axis=-1) - 0.5), 0, width - 1)
    yb0 = jnp.clip(jnp.floor(jnp.min(y, axis=-1) - 0.5), 0, fh - 1)
    yb1 = jnp.clip(jnp.ceil(jnp.max(y, axis=-1) - 0.5), 0, fh - 1)
    y0 = jnp.clip(yb0 - y_off, 0, height - 1)
    y1 = jnp.clip(yb1 - y_off, 0, height - 1)
    offscreen = (
        (jnp.max(x, axis=-1) < 0.5)
        | (jnp.min(x, axis=-1) > width - 0.5)
        | (jnp.max(y, axis=-1) < y_off + 0.5)
        | (jnp.min(y, axis=-1) > y_off + height - 0.5)
    )
    ok = ok & ~offscreen
    bbox = jnp.stack([x0, y0, x1, y1], axis=-1).astype(jnp.int32)

    return TriangleSetup(
        a=a, b=b, c=c, zplane=jnp.stack([za, zb, zc], axis=-1),
        inv_area=inv_area, inv_w=inv_w, valid=ok, bbox=bbox,
        box=jnp.stack([x0, x1, yb0, yb1], axis=-1) + 0.5,
    )


# ------------------------------------------------------- SoA twins (round 5)
# Component-major (transposed) implementations of the near-clip + setup
# math, used by the static-scene front end: every value is a dense (T,)
# component (no (T, 3)-shaped intermediates); the ARITHMETIC (ops, operand pairing,
# reduction association) is transcribed literally from the row-major
# functions above, so results are value-identical.
#
# Conventions: corner tables are (k, 3T) with corner-major columns
# [c*T, (c+1)*T) — a corner's component is a contiguous static slice.


class TriangleSetupT(NamedTuple):
    """TriangleSetup in component-major layout: per-edge/per-corner lists
    of dense (T,) arrays (kept unstacked so XLA fuses the whole front
    end; stack only at consumption boundaries)."""

    a: list          # [3] of (T,)
    b: list          # [3] of (T,)
    c: list          # [3] of (T,)
    zplane: list     # [3] of (T,)  [za, zb, zc]
    inv_area: jnp.ndarray  # (T,)
    inv_w: list      # [3] of (T,)
    valid: jnp.ndarray     # (T,) bool
    bbox: list       # [4] of (T,) int32  [x0, y0, x1, y1]
    box: list        # [4] of (T,) f32  [x_lo, x_hi, y_lo, y_hi]

    def to_rowmajor(self) -> "TriangleSetup":
        """Adapter for consumers of the row-major NamedTuple (the
        VisibilityBuffer record; DCE'd when unused)."""
        return TriangleSetup(
            a=jnp.stack(self.a, -1), b=jnp.stack(self.b, -1),
            c=jnp.stack(self.c, -1), zplane=jnp.stack(self.zplane, -1),
            inv_area=self.inv_area, inv_w=jnp.stack(self.inv_w, -1),
            valid=self.valid, bbox=jnp.stack(self.bbox, -1),
            box=jnp.stack(self.box, -1),
        )


def _sum3(p0, p1, p2):
    """Bitwise-stable 3-term sum. XLA/LLVM contract explicit
    `a*b + c` chains into FMAs (skipping the product rounding), so a
    chain form diverges from the row-major code's
    materialize-products-then-reduce by ~1 ulp — which the edge-equation
    cancellation amplifies into visible depth-plane error (measured
    4.6e-5 absolute depth dev). stack+reduce reproduces jnp.sum /
    the broadcast-sum reduction EXACTLY."""
    return jnp.stack([p0, p1, p2], 0).sum(0)


def corner_transform_t(cw_t, m):
    """(4, 3T) corner table x (4, 4) matrix -> (4, 3T) clip components.

    The transposed form of transform_vertices' `world @ VP^T` (same
    length-4 dot pairs, same precision flags)."""
    return jnp.matmul(jnp.asarray(m), cw_t, precision="highest")


def clip_near_corners_t(clip_t, n_src: int):
    """clip_near_corners on component-major corners.

    clip_t: (4, 3T) clip positions, corner-major columns. Returns
    (tri2 [3][4] of (2T,) source corner comps, weights [3][3] of (2T,),
    valid (2T,)) — the output corners themselves are weights x tri2
    (built by the caller only if needed)."""
    T = n_src
    tri = [[clip_t[j, c * T:(c + 1) * T] for j in range(4)]
           for c in range(3)]  # [corner][comp] (T,)
    z = [tri[c][2] for c in range(3)]
    i0, i1, i2 = (zc >= 0.0 for zc in z)
    n_inside = (i0.astype(jnp.int32) + i1.astype(jnp.int32)
                + i2.astype(jnp.int32))

    rot_one = jnp.where(i0, 0, jnp.where(i1, 1, 2))
    rot_two = jnp.where(~i0, 1, jnp.where(~i1, 2, 0))
    rot = jnp.where(n_inside == 1, rot_one, rot_two)  # (T,)

    def _cyc(vals, i):
        return jnp.where(
            rot == 0, vals[i % 3],
            jnp.where(rot == 1, vals[(i + 1) % 3], vals[(i + 2) % 3]),
        )

    zr = [_cyc(z, c) for c in range(3)]

    def lerp_t(za, zb):
        return za / jnp.where(jnp.abs(za - zb) < 1e-20, 1e-20, za - zb)

    t01 = lerp_t(zr[0], zr[1])
    t12 = lerp_t(zr[1], zr[2])
    t02 = lerp_t(zr[0], zr[2])

    one = jnp.ones_like(t01)
    zero = jnp.zeros_like(t01)
    # mix((1-t)*wa + t*wb) transcribed literally per component (keeps
    # sign-of-zero semantics identical to the row-major form)
    wA = [one, zero, zero]
    wB = [zero, one, zero]
    wC = [zero, zero, one]

    def mix(wa, wb, t):
        return [(1.0 - t) * a_ + t * b_ for a_, b_ in zip(wa, wb)]

    wAB = mix(wA, wB, t01)
    wBC = mix(wB, wC, t12)
    wAC = mix(wA, wC, t02)

    case3 = [wA, wB, wC]
    case1 = [wA, wAB, wAC]
    case2 = [wA, wB, wBC]
    m3 = n_inside == 3
    m1 = n_inside == 1
    w1 = [[jnp.where(m3, case3[c][k],
                     jnp.where(m1, case1[c][k], case2[c][k]))
           for k in range(3)] for c in range(3)]
    w2 = [[[wA, wBC, wAC][c][k] for k in range(3)] for c in range(3)]

    def unrotate(w):
        return [[jnp.where(rot == 0, w[c][k % 3],
                           jnp.where(rot == 1, w[c][(k - 1) % 3],
                                     w[c][(k - 2) % 3]))
                 for k in range(3)] for c in range(3)]

    w1 = unrotate(w1)
    w2 = unrotate(w2)

    weights = [[jnp.concatenate([w1[c][k], w2[c][k]])
                for k in range(3)] for c in range(3)]  # [c][k] (2T,)
    tri2 = [[jnp.concatenate([tri[m][j], tri[m][j]]) for j in range(4)]
            for m in range(3)]  # [src corner][comp] (2T,)
    valid = jnp.concatenate([n_inside >= 1, n_inside == 2])
    return tri2, weights, valid


def _corners_from_weights_t(tri2, weights):
    """out[c][j] = sum_m weights[c][m] * tri2[m][j] (reduction matches
    the row-major broadcast-sum bitwise — see _sum3)."""
    return [[_sum3(weights[c][0] * tri2[0][j],
                   weights[c][1] * tri2[1][j],
                   weights[c][2] * tri2[2][j])
             for j in range(4)] for c in range(3)]


def triangle_setup_t(
    corners, valid, width: int, height: int, jitter=None,
    full_height: int | None = None, y_offset=None,
) -> TriangleSetupT:
    """triangle_setup on component-major corners ([3][4] of (T,))."""
    inv_w, x, y, d = [], [], [], []
    for c in range(3):
        w = corners[c][3]
        iw = 1.0 / jnp.where(jnp.abs(w) < 1e-20, 1e-20, w)
        ndc = [corners[c][j] * iw for j in range(3)]
        if jitter is not None:
            jit_ = jnp.asarray(jitter)
            ndc[0] = ndc[0] + jit_[0]
            ndc[1] = ndc[1] + jit_[1]
        inv_w.append(iw)
        x.append((ndc[0] * 0.5 + 0.5) * width)
        y.append((ndc[1] * 0.5 + 0.5) * (full_height or height))
        d.append(ndc[2])
    y_off = 0 if y_offset is None else y_offset

    area = (x[1] - x[0]) * (y[2] - y[0]) - (y[1] - y[0]) * (x[2] - x[0])
    s = jnp.where(area >= 0.0, 1.0, -1.0)
    abs_area = jnp.abs(area)
    ok = valid & (abs_area > 1e-12)

    a, b, cc, c_unb = [], [], [], []
    for j, k in ((1, 2), (2, 0), (0, 1)):  # edge i opposite corner i
        ai = -(y[k] - y[j]) * s
        bi = (x[k] - x[j]) * s
        ci = ((y[k] - y[j]) * x[j] - (x[k] - x[j]) * y[j]) * s
        inclusive = (ai > 0.0) | ((ai == 0.0) & (bi > 0.0))
        edge_len = jnp.sqrt(ai * ai + bi * bi)
        a.append(ai)
        b.append(bi)
        c_unb.append(ci)
        cc.append(jnp.where(inclusive, ci, ci - _FILL_EPS * edge_len))

    inv_area = 1.0 / jnp.where(abs_area < 1e-20, 1e-20, abs_area)
    za = _sum3(a[0] * d[0], a[1] * d[1], a[2] * d[2]) * inv_area
    zb = _sum3(b[0] * d[0], b[1] * d[1], b[2] * d[2]) * inv_area
    zc = _sum3(c_unb[0] * d[0], c_unb[1] * d[1],
               c_unb[2] * d[2]) * inv_area

    xmin = jnp.minimum(jnp.minimum(x[0], x[1]), x[2])
    xmax = jnp.maximum(jnp.maximum(x[0], x[1]), x[2])
    ymin = jnp.minimum(jnp.minimum(y[0], y[1]), y[2])
    ymax = jnp.maximum(jnp.maximum(y[0], y[1]), y[2])
    fh = full_height or height
    x0 = jnp.clip(jnp.floor(xmin - 0.5), 0, width - 1)
    x1 = jnp.clip(jnp.ceil(xmax - 0.5), 0, width - 1)
    yb0 = jnp.clip(jnp.floor(ymin - 0.5), 0, fh - 1)
    yb1 = jnp.clip(jnp.ceil(ymax - 0.5), 0, fh - 1)
    y0 = jnp.clip(yb0 - y_off, 0, height - 1)
    y1 = jnp.clip(yb1 - y_off, 0, height - 1)
    offscreen = (
        (xmax < 0.5) | (xmin > width - 0.5)
        | (ymax < y_off + 0.5) | (ymin > y_off + height - 0.5)
    )
    ok = ok & ~offscreen
    bbox = [v.astype(jnp.int32) for v in (x0, y0, x1, y1)]

    return TriangleSetupT(a=a, b=b, c=cc, zplane=[za, zb, zc],
                          inv_area=inv_area, inv_w=inv_w, valid=ok,
                          bbox=bbox,
                          box=[v + 0.5 for v in (x0, x1, yb0, yb1)])


PAIR_ALIGN = 8  # kernel DMA row alignment (segments may start anywhere;
                # kernels round the start down and skip, see kernel.py)


def bin_triangles(
    setup: TriangleSetup,
    width: int,
    height: int,
    tile_h: int,
    tile_w: int,
    pair_capacity: int,
):
    """Expand triangles into per-tile work lists (sorted segment layout).

    The reference leans on the hardware rasterizer's own binning; here this
    is the tile kernel's work list (raster/kernel.py), built with one
    row-repeat, one single-key sort (tile id and triangle id packed into
    one int32 — no argsort + payload gather) and one vectorized
    searchsorted for the segment table. Segments are dense.

    Returns (pair_tri (CAP,) int32 sorted segment layout (-1 = padding),
    seg_starts (n_tiles,) int32 dense starts, seg_counts (n_tiles,) int32,
    overflow () int32 — dropped pairs, 0 in healthy runs).
    """
    return bin_triangles_t(
        [setup.bbox[:, i] for i in range(4)], setup.valid,
        width, height, tile_h, tile_w, pair_capacity,
    )


def bin_triangles_t(
    bbox,   # [4] of (T,) int32 components [x0, y0, x1, y1]
    valid,  # (T,) bool
    width: int,
    height: int,
    tile_h: int,
    tile_w: int,
    pair_capacity: int,
):
    """bin_triangles on bbox components (shared body — the binning math
    is 1-D throughout)."""
    tiles_x = -(-width // tile_w)
    tiles_y = -(-height // tile_h)
    n_tiles = tiles_x * tiles_y

    bx0 = bbox[0] // tile_w
    by0 = bbox[1] // tile_h
    bx1 = bbox[2] // tile_w
    by1 = bbox[3] // tile_h
    wspan = jnp.where(valid, bx1 - bx0 + 1, 0)
    hspan = jnp.where(valid, by1 - by0 + 1, 0)
    counts = wspan * hspan  # (T,)

    starts = jnp.cumsum(counts) - counts  # exclusive prefix
    total = starts[-1] + counts[-1] if counts.shape[0] > 0 else 0
    cap = pair_capacity
    n_tri = counts.shape[0]

    # One fused row-repeat for every per-pair triangle field.
    tri_ids = jnp.arange(n_tri, dtype=jnp.int32)
    tri_tbl = jnp.stack(
        [starts.astype(jnp.int32), bx0.astype(jnp.int32),
         by0.astype(jnp.int32), jnp.maximum(wspan, 1).astype(jnp.int32),
         tri_ids],
        axis=-1,
    )  # (T, 5)
    pv = jnp.repeat(tri_tbl, counts, axis=0, total_repeat_length=cap)
    slot = jnp.arange(cap, dtype=jnp.int32)
    pair_valid = slot < jnp.minimum(total, cap)
    kk = slot - pv[:, 0]
    tx = pv[:, 1] + kk % pv[:, 3]
    ty = pv[:, 2] + kk // pv[:, 3]
    tile_id = jnp.where(pair_valid, ty * tiles_x + tx, n_tiles)
    pair_tri = pv[:, 4]

    # Pack (tile, tri) into one sort key: a plain jnp.sort of one int32
    # array replaces argsort + two payload gathers. A triangle contributes
    # at most one pair per tile, so in-tile order by triangle id equals the
    # old in-tile order by emission slot.
    shift = max(n_tri, 1).bit_length()
    if (n_tiles + 1) << shift <= 2**31:
        key = (tile_id << shift) | pair_tri
        skey = jnp.sort(key)
        tile_sorted = skey >> shift
        pair_tri_sorted = jnp.where(
            tile_sorted < n_tiles, skey & ((1 << shift) - 1), -1
        ).astype(jnp.int32)
    else:  # huge scenes: fall back to argsort + gather
        order = jnp.argsort(tile_id)
        tile_sorted = tile_id[order]
        pair_tri_sorted = jnp.where(
            tile_sorted < n_tiles, pair_tri[order], -1
        ).astype(jnp.int32)

    offsets = jnp.searchsorted(
        tile_sorted, jnp.arange(n_tiles + 1, dtype=jnp.int32), side="left"
    ).astype(jnp.int32)
    seg_counts = offsets[1:] - offsets[:-1]  # (n_tiles,)
    seg_starts = offsets[:-1]

    overflow = jnp.maximum(total - cap, 0).astype(jnp.int32)
    return pair_tri_sorted, seg_starts, seg_counts, overflow
