"""The plain reprojection path (TAA / GTAO / SSR-blur history fetches):
a bilinear gather at pixel uv + velocity, sampled where the reference's
hardware sampler samples (linear filter, clamp-to-edge)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from vkr.passes.sampling import (reproject_bilinear, screen_uv_grid,
                                 upsample_half_bilinear)


def _img(h, w, c=None, seed=0):
    rng = np.random.default_rng(seed)
    shape = (h, w) if c is None else (h, w, c)
    return jnp.asarray(rng.random(shape), jnp.float32)


def _numpy_bilinear(img, x, y):
    """Reference sampler in numpy: texel-space (x, y) of sample points,
    clamp-to-edge taps."""
    img = np.asarray(img, np.float64)
    h, w = img.shape[:2]
    x0 = np.floor(x).astype(int)
    y0 = np.floor(y).astype(int)
    fx, fy = x - x0, y - y0

    def tap(xi, yi):
        return img[np.clip(yi, 0, h - 1), np.clip(xi, 0, w - 1)]

    if img.ndim == 3:
        fx, fy = fx[..., None], fy[..., None]
    top = tap(x0, y0) * (1 - fx) + tap(x0 + 1, y0) * fx
    bot = tap(x0, y0 + 1) * (1 - fx) + tap(x0 + 1, y0 + 1) * fx
    return top * (1 - fy) + bot * fy


@pytest.mark.parametrize("shape", [(16, 24), (9, 33, 3)])
def test_zero_velocity_is_identity(shape):
    img = _img(*shape)
    vel = jnp.zeros(shape[:2] + (2,), jnp.float32)
    np.testing.assert_allclose(np.asarray(reproject_bilinear(img, vel)),
                               np.asarray(img), atol=1e-6)


@pytest.mark.parametrize("offset", [(1, 0), (0, -1), (-1, 1)])
def test_texel_offset_shifts_with_edge_clamp(offset):
    h, w = 12, 20
    img = _img(h, w, seed=1)
    out = np.asarray(reproject_bilinear(
        img, jnp.zeros((h, w, 2)), texel_offset=offset))
    ys, xs = np.mgrid[0:h, 0:w]
    want = np.asarray(img)[np.clip(ys + offset[1], 0, h - 1),
                           np.clip(xs + offset[0], 0, w - 1)]
    np.testing.assert_allclose(out, want, atol=1e-6)


def test_far_offsets_clamp_to_edge_texels():
    """No window clamp: a velocity far outside the image samples the
    edge texel, exactly as the reference sampler does."""
    h, w = 10, 14
    img = _img(h, w, seed=2)
    vel = jnp.broadcast_to(jnp.asarray([3.0, -2.5], jnp.float32),
                           (h, w, 2))
    out = np.asarray(reproject_bilinear(img, vel))
    # x lands past the right edge, y above the top: texel (0, w-1)
    np.testing.assert_allclose(out, np.asarray(img)[0, w - 1], atol=1e-6)


def test_matches_numpy_sampler_at_fractional_offsets():
    h, w = 18, 26
    img = _img(h, w, 2, seed=3)
    rng = np.random.default_rng(4)
    vel = rng.uniform(-0.3, 0.3, (h, w, 2)).astype(np.float32)
    out = np.asarray(reproject_bilinear(img, jnp.asarray(vel)))
    uv = np.asarray(screen_uv_grid(h, w)) + vel
    want = _numpy_bilinear(img, uv[..., 0] * w - 0.5, uv[..., 1] * h - 0.5)
    np.testing.assert_allclose(out, want, atol=1e-5)


@pytest.mark.parametrize("row0", [0, 6])
def test_row0_band_matches_full_frame_rows(row0):
    """Band mode: the velocity covers rows [row0, row0 + bh) of the full
    image; the result equals those rows of the full-frame call."""
    h, w, bh = 16, 24, 6
    img = _img(h, w, 3, seed=5)
    vel = jnp.asarray(np.random.default_rng(6).uniform(
        -0.1, 0.1, (h, w, 2)), jnp.float32)
    full = np.asarray(reproject_bilinear(img, vel))
    band = np.asarray(jax.jit(
        lambda v, r: reproject_bilinear(img, v, row0=r))(
            vel[row0:row0 + bh], jnp.int32(row0)))
    # jit vs eager: the fused lerp may round differently (~1 ulp)
    np.testing.assert_allclose(band, full[row0:row0 + bh], atol=1e-5)


def test_taa_six_taps_are_plain_reprojections():
    """taa_resolve's history clamp box + prev-depth tap are six
    reproject_bilinear calls (centre, 4 neighbours, depth): rebuild the
    resolve from them and compare."""
    from vkr.mathlib.projection import reconstruct_view_vec
    from vkr.mathlib.transforms import transform_points
    from vkr.passes.taa import TAAParams, taa_resolve

    h, w = 12, 16
    rng = np.random.default_rng(7)
    hist = _img(h, w, 3, seed=8)
    cur = _img(h, w, 3, seed=9)
    hdepth = jnp.asarray(rng.uniform(0.9, 0.99, (h, w)), jnp.float32)
    cdepth = jnp.asarray(rng.uniform(0.9, 0.99, (h, w)), jnp.float32)
    vel = jnp.asarray(rng.uniform(-0.05, 0.05, (h, w, 2)), jnp.float32)
    eye = jnp.eye(4, dtype=jnp.float32)
    p = TAAParams(inverse_camera=eye, prev_inverse_camera=eye,
                  fovy=1.0, aspect=w / h, znear=0.1, zfar=50.0)
    out = np.asarray(taa_resolve(hist, hdepth, cdepth, vel, cur, p))

    def tap(img, off=None):
        return reproject_bilinear(img, vel, texel_offset=off)

    c = [tap(hist, o) for o in ((1, 0), (0, 1), (-1, 0), (0, -1))]
    lo = jnp.minimum(jnp.minimum(c[0], c[1]), jnp.minimum(c[2], c[3]))
    hi = jnp.maximum(jnp.maximum(c[0], c[1]), jnp.maximum(c[2], c[3]))
    blended = jnp.clip(tap(hist), lo, hi)
    blended = blended + (cur - blended) * 0.1
    uv = screen_uv_grid(h, w)
    w_cur = transform_points(reconstruct_view_vec(
        uv, cdepth, p.fovy, p.aspect, p.znear, p.zfar), eye)
    w_prev = transform_points(reconstruct_view_vec(
        uv + vel, tap(hdepth), p.fovy, p.aspect, p.znear, p.zfar), eye)
    err = jnp.linalg.norm(w_cur - w_prev, axis=-1)
    dist = jnp.linalg.norm(w_cur, axis=-1)
    vlen = jnp.linalg.norm(vel, axis=-1)
    prev_uv = uv + vel
    inb = ((prev_uv >= 0) & (prev_uv <= 1)).all(-1)
    keep = inb & ((vlen < 0.005)
                  | (err < jnp.clip(0.1 * dist * vlen, 0.01, 0.2)))
    want = np.asarray(jnp.where(keep[..., None], blended, cur))
    np.testing.assert_allclose(out, want, atol=1e-5)


@pytest.mark.parametrize("offset", [(0, 0), (1, 0), (0, 1), (1, 1)])
def test_half_res_upsample_is_rounding_stable(offset):
    """upsample_half_bilinear equals a float32 numpy evaluation of
    mid + 0.25 * (neighbour - mid) per axis bit for bit, also when a
    consumer's subtraction is fused into it: deferred shading picks its
    tap by comparing these values."""
    h, w = 14, 22
    img = np.asarray(_img(h, w, seed=10))
    full = np.asarray(_img(2 * h, 2 * w, seed=11))

    def axis(a, ax, off):
        n = a.shape[ax]

        def shifted(k):
            return np.take(a, np.clip(np.arange(n) + k, 0, n - 1), axis=ax)

        lo, mid, hi = shifted(off - 1), shifted(off), shifted(off + 1)
        q = np.float32(0.25)
        return mid + q * (lo - mid), mid + q * (hi - mid)

    e, o = axis(img, 0, offset[1])
    rows = np.stack([e, o], 1).reshape(2 * h, w)
    e, o = axis(rows, 1, offset[0])
    want = np.stack([e, o], 2).reshape(2 * h, 2 * w)
    got = np.asarray(upsample_half_bilinear(jnp.asarray(img), offset))
    np.testing.assert_array_equal(got, want)
    delta = np.asarray(jax.jit(lambda i, f: jnp.abs(
        upsample_half_bilinear(i, offset) - f))(jnp.asarray(img), full))
    np.testing.assert_array_equal(delta, np.abs(want - full))

