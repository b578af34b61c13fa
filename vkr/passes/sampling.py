"""Image sampling helpers shared by the image-space passes.

The equivalent of the GLSL texture() / textureLod() calls against render
targets (DEFAULT_SAMPLER: linear filter, clamp-to-edge — samplers.hpp:36-50)
expressed as dense gathers over (H, W[, C]) arrays with uv in [0, 1].
"""

from __future__ import annotations

import jax.numpy as jnp


def _prep(img):
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    return img, squeeze


def bilinear_sample(img, uv, offset_texels=None):
    """texture(img, uv) with linear filter + clamp-to-edge.

    img: (H, W) or (H, W, C); uv: (..., 2) in [0,1].
    offset_texels: optional (2,) int offset in texel units (textureOffset).
    """
    img, squeeze = _prep(img)
    h, w = img.shape[:2]
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    if offset_texels is not None:
        x = x + offset_texels[0]
        y = y + offset_texels[1]
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0 = x0.astype(jnp.int32)
    y0 = y0.astype(jnp.int32)

    def tap(xi, yi):
        xi = jnp.clip(xi, 0, w - 1)
        yi = jnp.clip(yi, 0, h - 1)
        return img[yi, xi]

    t00 = tap(x0, y0)
    t10 = tap(x0 + 1, y0)
    t01 = tap(x0, y0 + 1)
    t11 = tap(x0 + 1, y0 + 1)
    top = t00 + (t10 - t00) * fx
    bot = t01 + (t11 - t01) * fx
    out = top + (bot - top) * fy
    return out[..., 0] if squeeze else out


def nearest_sample(img, uv, offset_texels=None):
    """texelFetch-style nearest sampling with clamp-to-edge."""
    img, squeeze = _prep(img)
    h, w = img.shape[:2]
    x = jnp.floor(uv[..., 0] * w).astype(jnp.int32)
    y = jnp.floor(uv[..., 1] * h).astype(jnp.int32)
    if offset_texels is not None:
        x = x + offset_texels[0]
        y = y + offset_texels[1]
    x = jnp.clip(x, 0, w - 1)
    y = jnp.clip(y, 0, h - 1)
    out = img[y, x]
    return out[..., 0] if squeeze else out


def texel_fetch(img, x, y):
    """texelFetch(img, ivec2(x, y)) with clamp-to-edge."""
    img, squeeze = _prep(img)
    h, w = img.shape[:2]
    x = jnp.clip(x, 0, w - 1)
    y = jnp.clip(y, 0, h - 1)
    out = img[y, x]
    return out[..., 0] if squeeze else out


def upsample_half_bilinear(img_half, texel_offset=(0, 0)):
    """Dense 2x bilinear upsample of a half-res target sampled at full-res
    pixel centers (optionally with a half-res texel offset) — the regular
    structure of texture(half_tex, full_uv) with linear filtering, without
    per-pixel gathers.

    Full pixel x maps to half coordinate x/2 - 0.25: even pixels blend
    columns (x/2 - 1, x/2) with weights (0.25, 0.75); odd pixels blend
    (x/2, x/2 + 1) with (0.75, 0.25). Same along y.
    """
    img, squeeze = _prep(img_half)
    ox, oy = int(texel_offset[0]), int(texel_offset[1])
    h, w, c = img.shape

    def axis_interp(a, axis, off):
        # neighbors at (i - 1 + off, i + off) / (i + off, i + 1 + off);
        # explicit slice+pad shifts
        def shifted(k):
            n = a.shape[axis]
            if k == 0:
                return a
            sl = [slice(None)] * a.ndim
            if k > 0:
                sl[axis] = slice(k, None)
                body = a[tuple(sl)]
                sl[axis] = slice(-1, None)
                edge = a[tuple(sl)]
                reps = [1] * a.ndim
                reps[axis] = k
                return jnp.concatenate([body, jnp.tile(edge, reps)],
                                       axis=axis)
            sl[axis] = slice(0, n + k)
            body = a[tuple(sl)]
            sl[axis] = slice(0, 1)
            edge = a[tuple(sl)]
            reps = [1] * a.ndim
            reps[axis] = -k
            return jnp.concatenate([jnp.tile(edge, reps), body],
                                   axis=axis)

        lo = shifted(off - 1)
        mid = shifted(off)
        hi = shifted(off + 1)
        # mid + 0.25 * (n - mid): the product is exact, so the result is
        # the same whether or not the compiler contracts it into an FMA.
        # Deferred shading picks among these taps by their depth, so one
        # ulp must not depend on how a program was fused (a band of the
        # multi-device frame against the full frame).
        even = mid + 0.25 * (lo - mid)
        odd = mid + 0.25 * (hi - mid)
        return even, odd

    e_y, o_y = axis_interp(img, 0, oy)
    rows = jnp.stack([e_y, o_y], axis=1).reshape(2 * h, w, c)
    e_x, o_x = axis_interp(rows, 1, ox)
    full = jnp.stack([e_x, o_x], axis=2).reshape(2 * h, 2 * w, c)
    return full[..., 0] if squeeze else full


def downsample_full_to_half(img_full):
    """Dense equivalent of bilinear-sampling a full-res image at half-res
    pixel centers: full coordinate 2x + 0.5 -> equal-weight 2x2 average."""
    img, squeeze = _prep(img_full)
    h, w, c = img.shape
    h2, w2 = h // 2, w // 2
    q = img[: 2 * h2, : 2 * w2].reshape(h2, 2, w2, 2, c)
    # an explicit sum order (not a reduce, whose order the compiler picks
    # per program): a band of the multi-device frame rounds like the
    # full frame
    out = ((q[:, 0, :, 0] + q[:, 0, :, 1]) + (q[:, 1, :, 0] + q[:, 1, :, 1])
           ) * 0.25
    return out[..., 0] if squeeze else out


def quad_pack(img):
    """Pack each texel's 2x2 bilinear footprint into one row:
    out[y, x] = [p(y,x), p(y,x+1), p(y+1,x), p(y+1,x+1)] per channel
    (edge-clamped). A bilinear sample then needs ONE row gather
    (bilinear_from_quad) instead of four."""
    img, squeeze = _prep(img)
    xr = jnp.concatenate([img[:, 1:], img[:, -1:]], axis=1)
    yd = jnp.concatenate([img[1:], img[-1:]], axis=0)
    yxd = jnp.concatenate([xr[1:], xr[-1:]], axis=0)
    return jnp.concatenate([img, xr, yd, yxd], axis=-1)


def bilinear_from_quad(qimg, channels: int, uv):
    """texture(img, uv) using a quad_pack'ed image: one gather per sample.

    qimg: (H, W, 4*C); returns (..., C) (or (...,) when channels == 1 and
    the source was 2D — caller squeezes)."""
    h, w = qimg.shape[:2]
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    # Left/top edge: both hardware taps clamp to texel 0, so the lerp
    # weight must collapse to the first packed tap.
    fx = jnp.where(x0 < 0, 0.0, x - x0)[..., None]
    fy = jnp.where(y0 < 0, 0.0, y - y0)[..., None]
    xi = jnp.clip(x0.astype(jnp.int32), 0, w - 1)
    yi = jnp.clip(y0.astype(jnp.int32), 0, h - 1)
    rows = qimg[yi, xi]  # (..., 4C) — single gather
    if rows.dtype != jnp.float32:
        # sub-f32 storage (e.g. the reference's R16G16_SFLOAT BRDF
        # LUT): gather narrow, filter in f32 like the sampler hardware
        rows = rows.astype(jnp.float32)
    c = channels
    t00 = rows[..., 0 * c : 1 * c]
    t10 = rows[..., 1 * c : 2 * c]
    t01 = rows[..., 2 * c : 3 * c]
    t11 = rows[..., 3 * c : 4 * c]
    top = t00 + (t10 - t00) * fx
    bot = t01 + (t11 - t01) * fx
    return top + (bot - top) * fy


def downsample_full_to_half_corner(img_full):
    """Dense equivalent of bilinear-sampling a full-res image at half-res
    CORNER-convention uv (uv = pixel/size, as sssr filter.comp uses): full
    coordinate 2x - 0.5 -> equal-weight average of texels (2x-1, 2x),
    clamped at the edge."""
    img, squeeze = _prep(img_full)
    h, w, c = img.shape

    def shift_avg(a, axis):
        sl = [slice(None)] * a.ndim
        sl[axis] = slice(0, -1)
        body = a[tuple(sl)]
        sl[axis] = slice(0, 1)
        edge = a[tuple(sl)]
        shifted = jnp.concatenate([edge, body], axis=axis)
        return 0.5 * (shifted + a)

    out = shift_avg(shift_avg(img, 0), 1)[::2, ::2]
    return out[..., 0] if squeeze else out


def reproject_bilinear(img, uv_offset, *, texel_offset=None, row0=None):
    """Bilinear sample at (pixel uv + uv_offset), the reprojection pattern
    of TAA / temporal accumulation (a hardware sampler fetch in the
    reference; a plain gather that XLA fuses with the lerp here).
    texel_offset: optional (2,) constant texel offset (textureOffset
    analog).

    row0 (band mode): uv_offset covers only output rows
    [row0, row0 + bh) of the full `img`; row0 may be traced.
    """
    h, w = img.shape[:2]
    bh = uv_offset.shape[0]
    uv = screen_uv_grid(bh, w, row0=0 if row0 is None else row0,
                        full_height=h) + uv_offset
    return bilinear_sample(
        img, uv,
        None if texel_offset is None else jnp.asarray(texel_offset),
    )


def screen_uv_grid(height: int, width: int, row0=0, full_height=None):
    """Per-pixel uv at pixel centers — the fullscreen-triangle varying
    (screen_uv in the deferred shaders).

    row0/full_height: band mode (parallel/band.py) — the grid covers
    rows [row0, row0 + height) of a full_height-tall frame. row0 may be
    traced (lax.axis_index under shard_map)."""
    fh = height if full_height is None else full_height
    u = (jnp.arange(width, dtype=jnp.float32) + 0.5) / width
    v = (row0 + jnp.arange(height, dtype=jnp.float32) + 0.5) / fh
    uu, vv = jnp.meshgrid(u, v)
    return jnp.stack([uu, vv], axis=-1)
