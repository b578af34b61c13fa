"""PBR BRDF math.

Same formulas as the reference's shaders/include/brdf.glsl: GGX NDF
(brdf.glsl:31-38 alpha-parameterized variant), height-correlated Smith G2
(brdf.glsl:48-56), Schlick fresnel (brdf.glsl:6-8), F0 approximation
(brdf.glsl:10-13), and the Heitz GGX VNDF sampler (brdf.glsl:147-167).
All functions broadcast over leading axes; vectors stack on the last axis.
"""

from __future__ import annotations

import jax.numpy as jnp

PI = 3.1415926535897932384626433832795


def fresnel_schlick(cos_theta, f0):
    """cos_theta: (...,), f0: (..., C) or (...,). Broadcasts over the
    trailing component axis if f0 has one."""
    c = jnp.clip(1.0 - cos_theta, 0.0, 1.0) ** 5
    if jnp.ndim(f0) > jnp.ndim(cos_theta):
        c = c[..., None]
    return f0 + (1.0 - f0) * c


def f0_approximation(albedo, metallic):
    """mix(0.04, albedo, metallic)."""
    base = jnp.full_like(albedo, 0.04)
    m = metallic[..., None] if jnp.ndim(metallic) < albedo.ndim else metallic
    return base + (albedo - base) * m


def distribution_ggx(n_dot_h, alpha):
    """GGX NDF, alpha-parameterized (brdf.glsl:31-38). Zero for back-facing.

    den is clamped away from 0 (noh == +-1 with alpha == 0 would be 0/0;
    shader fast-math flushes this, IEEE f32 in XLA does not)."""
    alpha2 = alpha * alpha
    noh2 = n_dot_h * n_dot_h
    den = noh2 * alpha2 + (1.0 - noh2)
    den = jnp.maximum(den * den, 1e-12)
    return jnp.where(noh2 > 0.0, alpha2, 0.0) / (PI * den)


def brdf_g1(alpha2, n_dot_v):
    """Smith G1 (brdf.glsl:42-46). ndv clamped away from 0 (0*inf = NaN
    under IEEE; the shader relies on GPU fast-math here)."""
    ndv2 = jnp.maximum(n_dot_v * n_dot_v, 1e-8)
    tgv2 = (1.0 - ndv2) / ndv2
    return 2.0 / (1.0 + jnp.sqrt(1.0 + alpha2 * tgv2))


def brdf_g2(n_dot_v, n_dot_l, alpha2):
    """Height-correlated Smith G2 (brdf.glsl:48-56). Grazing-angle inputs
    clamped away from 0 (see brdf_g1)."""
    ndv2 = jnp.maximum(n_dot_v * n_dot_v, 1e-8)
    ndl2 = jnp.maximum(n_dot_l * n_dot_l, 1e-8)
    l1 = jnp.sqrt(1.0 + alpha2 * (1.0 - ndv2) / ndv2)
    l2 = jnp.sqrt(1.0 + alpha2 * (1.0 - ndl2) / ndl2)
    return 2.0 / (l1 + l2)


def sample_ggx_vndf(ve, alpha_x, alpha_y, u1, u2):
    """Heitz 2018 GGX VNDF sampling (brdf.glsl:147-167).

    ve: view direction in tangent space (..., 3), z up. u1/u2: uniforms (...).
    Returns the sampled microfacet normal (..., 3).
    """
    vh = jnp.stack(
        [alpha_x * ve[..., 0], alpha_y * ve[..., 1], ve[..., 2]], axis=-1
    )
    vh = vh / jnp.linalg.norm(vh, axis=-1, keepdims=True)

    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    inv_len = 1.0 / jnp.sqrt(jnp.maximum(lensq, 1e-20))
    t1 = jnp.where(
        (lensq > 0.0)[..., None],
        jnp.stack([-vh[..., 1] * inv_len, vh[..., 0] * inv_len,
                   jnp.zeros_like(inv_len)], axis=-1),
        jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0], vh.dtype), vh.shape),
    )
    t2 = jnp.cross(vh, t1)

    r = jnp.sqrt(u1)
    phi = 2.0 * PI * u2
    p1 = r * jnp.cos(phi)
    p2 = r * jnp.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * jnp.sqrt(1.0 - p1 * p1) + s * p2

    nh = (
        p1[..., None] * t1
        + p2[..., None] * t2
        + jnp.sqrt(jnp.maximum(0.0, 1.0 - p1 * p1 - p2 * p2))[..., None] * vh
    )
    ne = jnp.stack(
        [alpha_x * nh[..., 0], alpha_y * nh[..., 1],
         jnp.maximum(0.0, nh[..., 2])], axis=-1
    )
    return ne / jnp.linalg.norm(ne, axis=-1, keepdims=True)


def halton(index, base):
    """Halton low-discrepancy sequence (advanced_ssr.cpp:8-21), scalar python.

    Used to build the 64-entry (halton(2), halton(3)) table uploaded to the
    SSR trace kernel (advanced_ssr.cpp:23-34).
    """
    f = 1.0
    r = 0.0
    i = index
    while i > 0:
        f = f / base
        r = r + f * (i % base)
        i = i // base
    return r


def halton23_table(count: int):
    """(count, 2) float32 numpy table of (halton(i+1,2), halton(i+1,3))."""
    import numpy as np

    out = np.zeros((count, 2), dtype=np.float32)
    for i in range(count):
        out[i, 0] = halton(i + 1, 2)
        out[i, 1] = halton(i + 1, 3)
    return out
