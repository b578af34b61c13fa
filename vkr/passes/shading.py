"""Deferred PBR shading pass.

Same math as the reference's defered_shading/shader.frag: one hard-coded
point light with GGX specular (alpha-parameterized NDF + height-correlated
Smith G2) + Lambert diffuse + 0.6 ambient, SSR reflections applied through
the split-sum BRDF LUT, and AO/reflections fetched from half-res with the
4-tap nearest-depth upsample (sample_ocllusion_ssr, shader.frag:104-129).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from vkr.mathlib.transforms import transform_points
from vkr.mathlib.brdf import (
    PI,
    brdf_g2,
    distribution_ggx,
    f0_approximation,
    fresnel_schlick,
)
from vkr.mathlib.octahedral import decode_normal
from vkr.mathlib.projection import reconstruct_view_vec
from vkr.passes.sampling import screen_uv_grid

from vkr.core.registry import register

LIGHT_POS = (-1.85867, 5.81832, -0.247114)   # shader.frag:36
LIGHT_RADIANCE = (0.1, 0.1, 0.1)             # shader.frag:37


class ShadingParams(NamedTuple):
    inverse_camera: jnp.ndarray  # (4,4) view -> world
    fovy: float
    aspect: float
    znear: float
    zfar: float
    min_roughness: float = 0.0   # defered_shading.hpp:30
    max_roughness: float = 1.0
    show_ao: bool = False


def sample_occlusion_ssr(depth_full, depth_half, occlusion, reflections,
                         uv, row0=None):
    """Depth-aware 4-tap half-res upsample (shader.frag:104-129): pick the
    half-res texel (of 4 neighbors) whose depth best matches full-res.

    The taps are regular-grid (full-res pixel centers + constant texel
    offsets), so they run as dense 2x upsampling instead of gathers.

    row0 (band mode, FULL-res rows, even): depth_full covers only the
    band; the half-res inputs stay full and are sliced with a 2-row
    halo so the upsample phases/edge clamps match the full frame."""
    from vkr.passes.sampling import upsample_half_bilinear

    banded = row0 is not None
    if banded:
        bhf = depth_full.shape[0]      # full-res band rows (even)
        bhh = bhf // 2

        def half_hal(a):
            ap = jnp.pad(a, ((2, 2),) + ((0, 0),) * (a.ndim - 1),
                         mode="edge")
            return jax.lax.dynamic_slice(
                ap, (row0 // 2,) + (0,) * (a.ndim - 1),
                (bhh + 4,) + a.shape[1:])

        depth_half = half_hal(depth_half)
        occlusion = half_hal(occlusion)
        reflections = half_hal(reflections)

        def trim(a):
            # upsampled local rows [4, 4 + bhf) are the band
            return a[4 : 4 + bhf]
    else:
        def trim(a):
            return a

    deltas = []
    occ = []
    refl = []
    for off in ((0, 0), (1, 0), (0, 1), (1, 1)):
        d = trim(upsample_half_bilinear(depth_half, off))
        deltas.append(jnp.abs(d - depth_full))
        occ.append(trim(upsample_half_bilinear(occlusion, off)))
        refl.append(trim(upsample_half_bilinear(reflections, off)))
    deltas = jnp.stack(deltas, axis=-1)
    best = jnp.argmin(deltas, axis=-1)
    occ = jnp.stack(occ, axis=-1)
    refl = jnp.stack(refl, axis=-1)
    occlusion_out = jnp.take_along_axis(occ, best[..., None], -1)[..., 0]
    reflection_out = jnp.take_along_axis(
        refl, best[..., None, None], -1)[..., 0]
    return occlusion_out, reflection_out


@register("defered_shading")
def deferred_shading(
    gbuffer,
    params: ShadingParams,
    occlusion=None,       # (H/2, W/2) accumulated AO (gtao) or None
    reflections=None,     # (H/2, W/2, 3) blurred SSR or None
    brdf_lut=None,        # (S, S, 2) split-sum LUT or None
    depth_half=None,      # (H/2, W/2) depth mip 1 (for the upsample)
    row0=None,            # band mode: FULL-res first row (even; traced ok)
    band_h=None,          # band mode: FULL-res band height
):
    H, w = gbuffer.depth.shape
    banded = row0 is not None
    h = band_h if banded else H
    uv = screen_uv_grid(h, w, row0=row0 if banded else 0, full_height=H)

    def band(a):
        if not banded:
            return a
        return jax.lax.dynamic_slice(
            a, (row0,) + (0,) * (a.ndim - 1), (h,) + a.shape[1:])

    normal = decode_normal(band(gbuffer.normal))
    albedo = band(gbuffer.albedo)[..., :3]
    material = band(gbuffer.material)
    depth = band(gbuffer.depth)

    use_occlusion = occlusion is not None and depth_half is not None
    if use_occlusion:
        if reflections is None:
            reflections = jnp.zeros((*occlusion.shape, 3), jnp.float32)
        occ, refl = sample_occlusion_ssr(
            depth, depth_half, occlusion, reflections, uv, row0=row0
        )
    else:
        occ = jnp.ones_like(depth)
        refl = jnp.zeros((h, w, 3), jnp.float32)

    view_vec = reconstruct_view_vec(
        uv, depth, params.fovy, params.aspect, params.znear, params.zfar
    )
    inv_cam = jnp.asarray(params.inverse_camera)
    world_pos = transform_points(view_vec, inv_cam)
    camera_pos = inv_cam[:3, 3]

    metallic = 0.1 + 0.9 * material[..., 2]   # mix(0.1, 1.0, material.b)
    roughness = material[..., 1]

    v = camera_pos[None, None, :] - world_pos
    v = v / jnp.linalg.norm(v, axis=-1, keepdims=True).clip(1e-20)
    n = normal

    f0 = f0_approximation(albedo, metallic)

    light_pos = jnp.asarray(LIGHT_POS, jnp.float32)
    to_light = light_pos[None, None, :] - world_pos
    light_dist = jnp.linalg.norm(to_light, axis=-1)
    l = to_light / light_dist[..., None].clip(1e-20)
    hvec = v + l
    hvec = hvec / jnp.linalg.norm(hvec, axis=-1, keepdims=True).clip(1e-20)

    radiance = jnp.asarray(LIGHT_RADIANCE, jnp.float32)[None, None, :] * (
        jnp.minimum(100.0 / (light_dist * light_dist), 100.0)[..., None]
    )

    ndl = jnp.maximum((n * l).sum(-1), 0.0)
    ndv = jnp.maximum((n * v).sum(-1), 0.0)
    ndh = (n * hvec).sum(-1)
    hdv = jnp.maximum((hvec * v).sum(-1), 0.0)

    ndf = distribution_ggx(ndh, roughness)
    g = brdf_g2(ndv, ndl, roughness * roughness)
    f = fresnel_schlick(hdv, f0)

    ks = f
    kd = (1.0 - ks) * (1.0 - metallic)[..., None]
    specular = (ndf * g)[..., None] * f / (4.0 * ndv * ndl + 1e-4)[..., None]

    lo = (kd * albedo / PI + specular) * radiance * ndl[..., None]

    biased_roughness = (
        params.min_roughness
        + (params.max_roughness - params.min_roughness) * roughness
    )
    if brdf_lut is not None:
        from vkr.passes.sampling import bilinear_from_quad, quad_pack

        lut_uv = jnp.stack([biased_roughness, ndv], axis=-1)
        ssr_brdf = bilinear_from_quad(quad_pack(brdf_lut), 2, lut_uv)
        lo = lo + refl * (
            f0 * ssr_brdf[..., 0:1] + ssr_brdf[..., 1:2]
        )

    color = occ[..., None] * (0.6 * albedo + lo)

    if params.show_ao:
        return jnp.repeat(occ[..., None], 3, axis=-1)
    return color
