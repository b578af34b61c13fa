"""Shadow-map render path + shadow-factor sampling.

The reference carries a complete (but disabled) shadow pipeline: a
depth-only raster from the light's view — SceneRenderer::render_shadow
(scene_renderer.cpp:222-260, commented out pending its scene-traverse
rewrite) with the 'default_shadow' program (shaders/shadows/default.vert:
gl_Position = shadow_mvp * model * pos, empty fragment) — and the shadow
texture is created and bound to deferred shading every frame
(main.cpp:279,390) whose shader never reads it. This module provides the
same capability at the same wiring level: an optional pass
(cfg-style opt-in by the caller), off by default like the reference.

The depth-only raster IS the visibility rasterizer without attributes
(raster/pipeline.rasterize with vertex_attrs=None: the tile kernel as a
z-pass); the shadow test is a depth compare against the light-space
reprojection with a constant bias.
"""

from __future__ import annotations

import jax.numpy as jnp

from vkr.mathlib.transforms import transform_points
from vkr.core.registry import register
from vkr.raster import rasterize, transform_vertices


@register("default_shadow")
def render_shadow_map(scene, shadow_mvp, size: int = 1024,
                      use_pallas: bool = True, interpret: bool = False):
    """Depth-only raster of the whole scene from the light
    (render_shadow / shaders/shadows/default.vert). Returns (size, size)
    f32 hardware depth, 1.0 clear."""
    clip = transform_vertices(
        scene.positions, scene.vert_transform, scene.transforms,
        jnp.asarray(shadow_mvp),
    )
    indices = jnp.concatenate([scene.tri_opaque, scene.tri_masked], axis=0)
    vis = rasterize(clip, indices, width=size, height=size,
                    use_pallas=use_pallas, interpret=interpret)
    return vis.depth


def sample_shadow_factor(world_pos, shadow_mvp, shadow_map,
                         bias: float = 2e-3):
    """1.0 where lit, 0.0 where occluded: project world positions into
    the light's clip space and depth-compare against the shadow map
    (nearest tap; the reference's pipeline stops before defining a
    filter, so the simplest compare is the faithful baseline).

    world_pos: (H, W, 3); shadow_map: (S, S) from render_shadow_map."""
    m = jnp.asarray(shadow_mvp)
    s = shadow_map.shape[0]
    ph = transform_points(world_pos, m, homogeneous=True)
    w = jnp.where(jnp.abs(ph[..., 3]) < 1e-20, 1e-20, ph[..., 3])
    ndc = ph[..., :3] / w[..., None]
    uv = ndc[..., :2] * 0.5 + 0.5
    xi = jnp.clip((uv[..., 0] * s).astype(jnp.int32), 0, s - 1)
    yi = jnp.clip((uv[..., 1] * s).astype(jnp.int32), 0, s - 1)
    occluder = jnp.take(shadow_map.reshape(-1), yi * s + xi)
    in_frustum = (
        (uv[..., 0] >= 0.0) & (uv[..., 0] <= 1.0)
        & (uv[..., 1] >= 0.0) & (uv[..., 1] <= 1.0)
        & (ndc[..., 2] >= 0.0) & (ndc[..., 2] <= 1.0) & (w > 0.0)
    )
    lit = ndc[..., 2] <= occluder + bias
    # outside the light frustum nothing occludes (reference clear = 1.0)
    return jnp.where(in_frustum, lit.astype(jnp.float32), 1.0)
