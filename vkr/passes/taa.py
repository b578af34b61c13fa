"""TAA resolve pass.

Reference: src/taa.cpp + shaders/taa/resolve.comp. The camera jitters
through the fixed 4-point sequence (main.cpp:93-108); resolve reprojects
uv + velocity, clamps the history sample to the min/max of its 4 immediate
neighbors, blends mix(history, current, 0.1), and validates reprojection by
world-space position error against a distance-scaled epsilon.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from vkr.mathlib.projection import reconstruct_view_vec
from vkr.mathlib.transforms import transform_points
from vkr.passes.sampling import screen_uv_grid

from vkr.core.registry import register


class TAAParams(NamedTuple):
    inverse_camera: jnp.ndarray
    prev_inverse_camera: jnp.ndarray
    fovy: float
    aspect: float
    znear: float
    zfar: float


@register("taa_resolve")
def taa_resolve(
    history_color,   # (H, W, 3)
    history_depth,   # (H, W) prev frame depth
    current_depth,   # (H, W)
    velocity,        # (H, W, 2)
    current_color,   # (H, W, 3)
    params: TAAParams,
    row0=None,
    band_h: "int | None" = None,
):
    """row0/band_h (band mode, parallel/band.py): compute only rows
    [row0, row0 + band_h); inputs stay FULL-frame (history reprojection
    reads a velocity-radius window)."""
    from vkr.passes.sampling import reproject_bilinear

    H, W = current_depth.shape
    banded = row0 is not None
    h = band_h if banded else H
    w = W
    uv = screen_uv_grid(h, w, row0=row0 if banded else 0, full_height=H)

    def band(a):
        if not banded:
            return a
        return jax.lax.dynamic_slice(
            a, (row0,) + (0,) * (a.ndim - 1), (h,) + a.shape[1:])

    velocity = band(velocity)
    current_color_c = band(current_color)
    depth_c = band(current_depth)
    delta_len = jnp.linalg.norm(velocity, axis=-1)
    prev_uv = uv + velocity
    in_bounds = (
        (prev_uv[..., 0] >= 0) & (prev_uv[..., 0] <= 1)
        & (prev_uv[..., 1] >= 0) & (prev_uv[..., 1] <= 1)
    )

    def hist_tap(texel_offset=None):
        return reproject_bilinear(history_color, velocity,
                                  texel_offset=texel_offset, row0=row0)

    history = hist_tap()
    c0 = hist_tap((1, 0))
    c1 = hist_tap((0, 1))
    c2 = hist_tap((-1, 0))
    c3 = hist_tap((0, -1))
    color_min = jnp.minimum(jnp.minimum(c0, c1), jnp.minimum(c2, c3))
    color_max = jnp.maximum(jnp.maximum(c0, c1), jnp.maximum(c2, c3))
    history = jnp.clip(history, color_min, color_max)

    blended = history + (current_color_c - history) * 0.1

    def world(dtex, inv_cam, suv, vel=None):
        if vel is None:
            d = dtex
        else:
            d = reproject_bilinear(dtex, vel, row0=row0)
        vc = reconstruct_view_vec(suv, d, params.fovy, params.aspect,
                                  params.znear, params.zfar)
        return transform_points(vc, inv_cam)

    w_cur = world(depth_c, params.inverse_camera, uv)
    w_prev = world(history_depth, params.prev_inverse_camera, prev_uv,
                   vel=velocity)
    cam = jnp.asarray(params.inverse_camera)[:3, 3]
    error = jnp.linalg.norm(w_cur - w_prev, axis=-1)
    pixel_dist = jnp.linalg.norm(w_cur - cam[None, None, :], axis=-1)
    reprojected = in_bounds & (
        (delta_len < 0.005)
        | (error < jnp.clip(0.1 * pixel_dist * delta_len, 0.01, 0.2))
    )

    return jnp.where(reprojected[..., None], blended,
                     current_color_c)
