"""Storage-format emulation.

The reference renders into typed Vulkan images — RGBA8_SRGB albedo/material,
RG16_UNORM octahedral normals, RG16F velocity, D24 depth
(scene_renderer.cpp:15-27). Here every render target is an f32 (or bf16)
array; to match the reference's precision at pass boundaries (PSNR parity,
SURVEY.md §7 hard part 4) we optionally round-trip values through the same
quantization the hardware formats would apply.
"""

from __future__ import annotations

import jax.numpy as jnp


def quantize_unorm(x, bits: int):
    """Round-trip through a bits-wide UNORM encoding ([0,1] clamped)."""
    scale = float((1 << bits) - 1)
    return jnp.round(jnp.clip(x, 0.0, 1.0) * scale) / scale


def quantize_d24(x):
    """Round-trip through a 24-bit depth format, on the 2^-24 grid.

    A D24 UNORM texel holds k / (2^24 - 1); this keeps k / 2^24, which
    differs by under 6e-8. The reason is the power of two: the division
    is an exact product, so the quantized depth is the same wherever the
    compiler recomputes it, fused into a consumer's subtraction or not.
    Depth feeds comparisons of nearly equal values (the nearest-depth
    upsample, the reprojection tests), which an ulp may tip."""
    scale = float(1 << 24)
    return jnp.round(jnp.clip(x, 0.0, 1.0) * scale) * (1.0 / scale)


def quantize_f16(x):
    """Round-trip through IEEE half precision (RG16F targets)."""
    return x.astype(jnp.float16).astype(jnp.float32)


def srgb_to_linear(c):
    """sRGB EOTF (what sampling an SRGB image does in hardware)."""
    c = jnp.clip(c, 0.0, 1.0)
    return jnp.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(c):
    """Inverse EOTF (what writing to an SRGB attachment does)."""
    c = jnp.clip(c, 0.0, 1.0)
    return jnp.where(
        c <= 0.0031308, c * 12.92, 1.055 * c ** (1.0 / 2.4) - 0.055
    )
