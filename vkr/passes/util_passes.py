"""Utility passes (reference src/util_passes.{hpp,cpp} + perlin shader):
perlin noise generation, mip-chain generation, clears, blits, and the
channel-select backbuffer view (backbuffer_subpass2 + texdraw shader).
"""

from __future__ import annotations

import enum
import math

import jax.numpy as jnp

from vkr.passes.sampling import bilinear_sample, screen_uv_grid

from vkr.core.registry import register


# ------------------------------------------------------------- perlin

_FIRST_OCTAVE = 3
_OCTAVES = 8
_PERSISTENCE = 0.6


def _lattice_noise(x, y):
    """perlin/shader.frag noise(): hash of integer lattice coords."""
    s = jnp.sin(x * 12.9898 + y * 78.233) * 43758.5453
    return 2.0 * (s - jnp.floor(s)) - 1.0


def _smooth_noise(x, y):
    c = _lattice_noise(x, y) / 4.0
    s = (
        _lattice_noise(x + 1, y) + _lattice_noise(x - 1, y)
        + _lattice_noise(x, y + 1) + _lattice_noise(x, y - 1)
    ) / 8.0
    d = (
        _lattice_noise(x + 1, y + 1) + _lattice_noise(x + 1, y - 1)
        + _lattice_noise(x - 1, y + 1) + _lattice_noise(x - 1, y - 1)
    ) / 16.0
    return c + s + d


def _cos_interp(a, b, t):
    f = (1.0 - jnp.cos(t * math.pi)) * 0.5
    return a * (1.0 - f) + b * f


def _interp_noise(x, y):
    ix = jnp.floor(x)
    iy = jnp.floor(y)
    fx = x - ix
    fy = y - iy
    v1 = _smooth_noise(ix, iy)
    v2 = _smooth_noise(ix + 1, iy)
    v3 = _smooth_noise(ix, iy + 1)
    v4 = _smooth_noise(ix + 1, iy + 1)
    return _cos_interp(_cos_interp(v1, v2, fx), _cos_interp(v3, v4, fx), fy)


@register("perlin")
def gen_perlin_noise2d(height: int, width: int, scale: float = 30.0):
    """util_passes gen_perlin_noise2D: octaved value noise over uv*30."""
    uv = screen_uv_grid(height, width)
    x = scale * uv[..., 0]
    y = scale * uv[..., 1]
    total = jnp.zeros((height, width), jnp.float32)
    for i in range(_FIRST_OCTAVE, _OCTAVES + _FIRST_OCTAVE):
        freq = 2.0 ** i
        amp = _PERSISTENCE ** i
        total = total + _interp_noise(x * freq, y * freq) * amp
    return total


# -------------------------------------------------------- mips / blit

def gen_mipmaps(img):
    """util_passes gen_mipmaps (blit chain): full 2x2-average mip pyramid,
    list ordered base first."""
    mips = [img]
    cur = img
    while min(cur.shape[:2]) > 1:
        h, w = cur.shape[:2]
        h2, w2 = max(h // 2, 1), max(w // 2, 1)
        cur = cur[: h2 * 2, : w2 * 2]
        if cur.ndim == 2:
            cur = cur.reshape(h2, 2, w2, 2).mean(axis=(1, 3))
        else:
            cur = cur.reshape(h2, 2, w2, 2, -1).mean(axis=(1, 3))
        mips.append(cur)
    return mips


def clear_color(height: int, width: int, value=(0.0, 0.0, 0.0, 0.0)):
    """util_passes clear_color."""
    return jnp.broadcast_to(
        jnp.asarray(value, jnp.float32), (height, width, len(value))
    )


def clear_depth(height: int, width: int, value: float = 1.0):
    """util_passes clear_depth."""
    return jnp.full((height, width), value, jnp.float32)


def blit_image(src, dst_height: int, dst_width: int):
    """util_passes blit_image: bilinear rescale to the target extent."""
    uv = screen_uv_grid(dst_height, dst_width)
    return bilinear_sample(src, uv)


# ----------------------------------------------- backbuffer / texdraw

class DrawTex(enum.IntEnum):
    """Channel-select flags (backbuffer_subpass2.hpp / texdraw shader)."""

    ShowAll = 0
    ShowR = 1
    ShowG = 2
    ShowB = 3
    ShowA = 4


@register("texdraw")
def backbuffer_draw(tex, height: int, width: int,
                    mode: DrawTex = DrawTex.ShowAll):
    """add_backbuffer_subpass analog: fullscreen textured draw with
    channel-select (texdraw/shader.frag:9-33). Returns (H, W, 3)."""
    if tex.ndim == 2:
        tex = tex[..., None]
    uv = screen_uv_grid(height, width)
    sampled = bilinear_sample(tex, uv)
    c = sampled.shape[-1]

    def chan(i):
        i = min(i, c - 1)
        return jnp.repeat(sampled[..., i : i + 1], 3, axis=-1)

    if mode == DrawTex.ShowAll:
        if c >= 3:
            return sampled[..., :3]
        return chan(0)
    return chan(int(mode) - 1)


@register("rotations")
def draw_directions(height: int, width: int, angle):
    """DrawDirs debug compute (draw_directions.hpp + the 'rotations'
    program, shaders/rotations/rot.comp): hashed stripes constant along
    the direction `angle` — the reference's interactive direction-
    visualization aid. Returns (H, W) f32 in [0, 1)."""
    x = jnp.arange(width, dtype=jnp.float32)[None, :]
    y = jnp.arange(height, dtype=jnp.float32)[:, None]
    c = -(x * jnp.cos(angle) + y * jnp.sin(angle))
    s = jnp.sin(c * 12.9898 + c * 78.233) * 43758.5453  # rand2D((c, c))
    return s - jnp.floor(s)
