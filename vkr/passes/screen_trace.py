"""Screen-space radiance trace (1-bounce SSGI experiment).

Reference: src/screen_trace.{hpp,cpp} + shaders/screen_trace/{trace,filter,
accumulate}.comp — a GTAO-style horizon march that also gathers the radiance
of visible samples (integrate_direction, trace.comp:50-80). Constructed in
older revisions of the reference, not wired into its main loop (SURVEY.md
§2.4); kept here for component parity.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from vkr.mathlib.transforms import apply_linear
from vkr.mathlib.brdf import distribution_ggx
from vkr.mathlib.octahedral import decode_normal
from vkr.mathlib.projection import (
    linearize_depth,
    reconstruct_view_vec,
)
from vkr.passes.sampling import bilinear_sample, screen_uv_grid

from vkr.core.registry import register

PI = math.pi
MAX_THICKNESS = 0.2   # trace.comp:38
SAMPLES = 20          # trace.comp:39


class ScreenTraceParams(NamedTuple):
    normal_mat: jnp.ndarray
    fovy: float
    aspect: float
    znear: float
    zfar: float


def _gtao_direction(height, width):
    x = jnp.arange(width, dtype=jnp.int32)[None, :]
    y = jnp.arange(height, dtype=jnp.int32)[:, None]
    return ((((x + y) & 3) << 2) + (x & 3)).astype(jnp.float32) / 16.0


@register("screen_trace_main")
def screen_trace(depth, normal_oct, color, params: ScreenTraceParams,
                 angle_offset=0.0, dirs_count: int = 1):
    """integrate_direction-based SSGI: marches each pixel's dither direction
    accumulating GGX-weighted radiance of horizon-visible samples.

    Returns (H, W, 4): rgb = radiance, a = GTAO-style visibility.
    """
    h, w = depth.shape
    uv = screen_uv_grid(h, w)
    size = jnp.asarray([w, h], jnp.float32)

    camera_pos = reconstruct_view_vec(
        uv, depth, params.fovy, params.aspect, params.znear, params.zfar
    )
    w0 = -camera_pos / jnp.linalg.norm(camera_pos, axis=-1,
                                       keepdims=True).clip(1e-20)
    nm = jnp.asarray(params.normal_mat)
    normal = apply_linear(decode_normal(normal_oct), nm[:3, :3])
    normal = normal / jnp.linalg.norm(normal, axis=-1,
                                      keepdims=True).clip(1e-20)

    # trace.comp:169: fixed 256-pixel radius
    dir_radius = 256.0 / size
    base_angle = _gtao_direction(h, w) + angle_offset

    total_vis = jnp.zeros((h, w), jnp.float32)
    total_rad = jnp.zeros((h, w, 3), jnp.float32)

    for d in range(dirs_count):
        angle = 2.0 * PI * (base_angle + d / dirs_count)
        dir_uv = dir_radius[None, None, :] * jnp.stack(
            [jnp.cos(angle), jnp.sin(angle)], -1
        )

        sample_end = reconstruct_view_vec(
            uv + dir_uv, depth, params.fovy, params.aspect, params.znear,
            params.zfar,
        )
        slice_n = jnp.cross(w0, -sample_end)
        slice_n = slice_n / jnp.linalg.norm(slice_n, axis=-1,
                                            keepdims=True).clip(1e-20)
        n_proj = normal - (normal * slice_n).sum(-1, keepdims=True) * slice_n
        n_len = jnp.linalg.norm(n_proj, axis=-1).clip(1e-20)
        to_end = sample_end - camera_pos
        to_end = to_end / jnp.linalg.norm(to_end, axis=-1,
                                          keepdims=True).clip(1e-20)
        n_ang = PI / 2.0 - jnp.arccos(
            jnp.clip(((n_proj / n_len[..., None]) * to_end).sum(-1), -1, 1)
        )

        def step(i, carry):
            h_cos, prev_z, alive, rad, rad_n = carry
            tc = uv + (i.astype(jnp.float32) / SAMPLES) * dir_uv
            sd = bilinear_sample(depth, tc)
            sp = reconstruct_view_vec(tc, sd, params.fovy, params.aspect,
                                      params.znear, params.zfar)
            alive = alive & ~(sp[..., 2] > prev_z + MAX_THICKNESS)
            prev_z = jnp.where(alive, sp[..., 2], prev_z)
            off = sp - camera_pos
            off = off / jnp.linalg.norm(off, axis=-1,
                                        keepdims=True).clip(1e-20)
            s_cos = (w0 * off).sum(-1)
            visible = alive & (s_cos >= h_cos)
            h_cos = jnp.where(visible, s_cos, h_cos)
            half = w0 + off
            half = half / jnp.linalg.norm(half, axis=-1,
                                          keepdims=True).clip(1e-20)
            ggx = distribution_ggx((normal * half).sum(-1), 0.8)
            contrib = (
                bilinear_sample(color[..., :3], tc)
                * jnp.maximum((normal * off).sum(-1), 0.0)[..., None]
                * ggx[..., None]
            )
            rad = rad + jnp.where(visible[..., None], contrib, 0.0)
            rad_n = rad_n + visible.astype(jnp.float32)
            return h_cos, prev_z, alive, rad, rad_n

        h_cos, _, _, rad, rad_n = jax.lax.fori_loop(
            1, SAMPLES + 1, step,
            (jnp.full((h, w), -1.0), camera_pos[..., 2],
             jnp.ones((h, w), bool),
             jnp.zeros((h, w, 3), jnp.float32),
             jnp.zeros((h, w), jnp.float32)),
        )
        rad = jnp.where((rad_n > 0)[..., None], rad / SAMPLES, 0.0)

        hh = jnp.arccos(jnp.clip(h_cos, -1.0, 1.0))
        hh = jnp.minimum(n_ang + jnp.minimum(hh - n_ang, PI / 2.0), hh)
        total_vis = total_vis + n_len * 0.25 * jnp.maximum(
            -jnp.cos(2 * hh - n_ang) + jnp.cos(n_ang)
            + 2 * hh * jnp.sin(n_ang), 0.0,
        )
        total_rad = total_rad + rad

    vis = 2.0 * total_vis / dirs_count
    out = jnp.concatenate(
        [total_rad / dirs_count, vis[..., None]], axis=-1
    )
    return jnp.where((depth >= 1.0)[..., None],
                     jnp.asarray([0.0, 0.0, 0.0, 1.0]), out)


@register("screen_trace_filter")
def screen_trace_filter(depth, raw, znear, zfar):
    """screen_trace/filter.comp: 4x4 depth-bilateral (offsets -2..+1,
    weight 1 - |dz| / (0.1 z))."""
    h, w = depth.shape
    z = linearize_depth(depth, znear, zfar)
    pad_d = jnp.pad(depth, 2, mode="edge")
    pad_r = jnp.pad(raw, ((2, 2), (2, 2), (0, 0)), mode="edge")
    wsum = jnp.zeros((h, w), jnp.float32)
    acc = jnp.zeros_like(raw)
    for dx in range(-2, 2):
        for dy in range(-2, 2):
            zs = linearize_depth(
                pad_d[2 + dy : 2 + dy + h, 2 + dx : 2 + dx + w], znear, zfar
            )
            wgt = jnp.maximum(0.0, 1.0 - jnp.abs(zs - z) / (z * 0.1))
            wsum = wsum + wgt
            acc = acc + wgt[..., None] * pad_r[2 + dy : 2 + dy + h,
                                               2 + dx : 2 + dx + w]
    return acc / jnp.maximum(wsum, 1e-20)[..., None]


@register("screen_trace_accumulate")
def screen_trace_accumulate(cur_depth, prev_depth, current, accum,
                            fovy, aspect, znear, zfar):
    """screen_trace/accumulate.comp: same-texel depth-validated exponential
    accumulation (coef 0.05)."""
    h, w = cur_depth.shape
    uv = screen_uv_grid(h, w)
    cur_view = reconstruct_view_vec(uv, cur_depth, fovy, aspect, znear,
                                    zfar)
    sampled_z = linearize_depth(prev_depth, znear, zfar)
    delta = jnp.abs(sampled_z - cur_view[..., 2])
    ok = (delta < 1e-6) & (prev_depth < 1.0)
    blended = accum + (current - accum) * 0.05
    return jnp.where(ok[..., None], blended, current)
