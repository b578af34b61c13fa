"""Legacy full-res mirror SSR pass (superseded by AdvancedSSR, kept for
component parity — src/ssr.{hpp,cpp} + shaders/ssr/shader.frag).

Mirror reflection R = reflect(view, normal) marched with the plain
hierarchical hi-Z raymarch (screen_trace.glsl:51-101), reflecting the lit
frame color.
"""

from __future__ import annotations

import jax.numpy as jnp

from vkr.mathlib.transforms import apply_linear
from vkr.mathlib.octahedral import decode_normal
from vkr.mathlib.projection import project_view_vec, reconstruct_view_vec
from vkr.passes.sampling import bilinear_sample, screen_uv_grid
from vkr.passes.ssr import FlatPyramid, SSRParams
from vkr.passes.ssr_march import march_plain

from vkr.core.registry import register


@register("ssr")
def simple_ssr(hiz: FlatPyramid, normal_oct, frame_color,
               params: SSRParams, max_iterations: int = 100):
    """(H, W) at the pyramid's base resolution -> (H, W, 4) reflection
    color (a = valid)."""
    h, w = hiz.heights[0], hiz.widths[0]
    uv = screen_uv_grid(h, w)
    size = jnp.asarray([w, h], jnp.float32)

    depth = hiz.flat[: h * w].reshape(h, w)
    nm = jnp.asarray(params.normal_mat)
    normal = apply_linear(decode_normal(normal_oct), nm[:3, :3])
    normal = normal / jnp.linalg.norm(normal, axis=-1,
                                      keepdims=True).clip(1e-20)
    view_vec = reconstruct_view_vec(uv, depth, params.fovy, params.aspect,
                                    params.znear, params.zfar)
    r = view_vec - 2.0 * (view_vec * normal).sum(-1, keepdims=True) * normal

    start = project_view_vec(view_vec + 0.0005 * normal, params.fovy,
                             params.aspect, params.znear, params.zfar)
    p = project_view_vec(view_vec + r, params.fovy, params.aspect,
                         params.znear, params.zfar)
    delta = p - start
    delta = delta / jnp.linalg.norm(delta, axis=-1,
                                    keepdims=True).clip(1e-20)

    dz_ok = jnp.abs(delta[..., 2]) >= 1e-7
    safe = lambda d: jnp.where(jnp.abs(d) < 1e-20, 1e-20, d)
    t_bound = (1.0 - start[..., 2]) / safe(delta[..., 2])
    u_bound = jnp.maximum((1.0 - start[..., 0]) / safe(delta[..., 0]),
                          -start[..., 0] / safe(delta[..., 0]))
    v_bound = jnp.maximum((1.0 - start[..., 1]) / safe(delta[..., 1]),
                          -start[..., 1] / safe(delta[..., 1]))
    t_bound = jnp.minimum(t_bound, jnp.minimum(u_bound, v_bound))
    direction = t_bound[..., None] * delta

    w0 = -view_vec / jnp.linalg.norm(view_vec, axis=-1,
                                     keepdims=True).clip(1e-20)
    out_ray, _hor, iters = march_plain(
        hiz, start, direction, view_vec, w0, params, max_iterations,
        find_hor=False,
    )
    valid = dz_ok & (iters <= max_iterations)

    dist0 = jnp.abs(out_ray[..., :2] - start[..., :2])
    min_dist = 2.0 / size
    valid = valid & ~(
        (dist0[..., 0] < min_dist[0]) & (dist0[..., 1] < min_dist[1])
    )
    hit_n = apply_linear(
        decode_normal(bilinear_sample(normal_oct, out_ray[..., :2])),
        nm[:3, :3])
    valid = valid & ((hit_n * r).sum(-1) <= 0)
    hit_depth = bilinear_sample(depth, out_ray[..., :2])
    valid = valid & (out_ray[..., 2] <= hit_depth + 1e-4)

    color = bilinear_sample(frame_color[..., :3], out_ray[..., :2])
    return jnp.where(
        valid[..., None],
        jnp.concatenate([color, jnp.ones((h, w, 1))], -1),
        0.0,
    )
