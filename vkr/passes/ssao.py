"""Legacy SSAO pass (superseded by GTAO in the reference main loop but part
of the component inventory — src/ssao.{hpp,cpp} + shaders/ssao/shader.frag).

16 unit-sphere samples scaled by 0.05 around the reconstructed view
position; each projected back to screen and depth-compared.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from vkr.mathlib.projection import reconstruct_view_vec
from vkr.passes.sampling import bilinear_sample, screen_uv_grid

from vkr.core.registry import register

SAMPLE_COUNT = 16


def sphere_samples(seed: int = 0) -> np.ndarray:
    """Rejection-sampled unit sphere directions (ssao.cpp:33-48)."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < SAMPLE_COUNT:
        v = rng.uniform(-1, 1, 3)
        l2 = float(v @ v)
        if l2 < 1.0 and l2 > 1e-12:
            out.append(v / np.sqrt(l2))
    return np.asarray(out, np.float32)


class SSAOParams(NamedTuple):
    projection: jnp.ndarray  # (4,4)
    fovy: float
    aspect: float
    znear: float
    zfar: float


@register("ssao")
def ssao(depth, params: SSAOParams, samples=None):
    """(H, W) depth -> (H, W) occlusion in [0,1] (1 = unoccluded)."""
    if samples is None:
        samples = sphere_samples()
    samples = jnp.asarray(samples)
    h, w = depth.shape
    uv = screen_uv_grid(h, w)
    camera_pos = reconstruct_view_vec(
        uv, depth, params.fovy, params.aspect, params.znear, params.zfar
    )
    proj = jnp.asarray(params.projection)

    def body(i, acc):
        pos = camera_pos + 0.05 * samples[i][None, None, :]
        ph = jnp.concatenate(
            [pos, jnp.ones((h, w, 1), jnp.float32)], -1
        ) @ proj.T
        ndc = ph[..., :3] / jnp.where(
            jnp.abs(ph[..., 3:4]) < 1e-20, 1e-20, ph[..., 3:4]
        )
        sample_uv = 0.5 * ndc[..., :2] + 0.5
        sample_depth = bilinear_sample(depth, sample_uv)
        return acc + jnp.where(ndc[..., 2] < sample_depth + 1e-7, 1.0, 0.0)

    acc = jax.lax.fori_loop(
        0, SAMPLE_COUNT, body, jnp.zeros((h, w), jnp.float32)
    )
    return acc / SAMPLE_COUNT
