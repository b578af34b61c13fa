"""G-buffer downsample / hi-Z pyramid pass.

Same algorithm as the reference's DownsamplePass (downsample_pass.cpp:60-135
+ advanced_ssr/downsample_gbuffer.frag + depth_downsample/shader.frag):
  * mip 1 of depth = min of each 2x2 quad, and half-res normal/velocity take
    the value of the min-depth texel of the quad (tie order d0,d1,d2,d3);
  * depth mips 2..N each min-downsample the previous mip.

Here these are dense reshape-reduce ops — the (8,4)/(8,8) workgroup grids
dissolve entirely.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import jax.numpy as jnp

from vkr.core.registry import register


class HiZPyramid(NamedTuple):
    mips: Tuple[jnp.ndarray, ...]   # depth mips 1..N (half-res down to 1)
    normal_half: jnp.ndarray        # (H/2, W/2, 2) oct normals
    velocity_half: jnp.ndarray      # (H/2, W/2, 2)

    @property
    def num_levels(self) -> int:
        return len(self.mips)


def _quads(img):
    """(H, W[, C]) -> (H/2, W/2, 4[, C]) quad gather in the reference's
    tie-break order: (0,0), (1,0), (0,1), (1,1) (dx, dy)."""
    h, w = img.shape[:2]
    rest = img.shape[2:]
    q = img.reshape(h // 2, 2, w // 2, 2, *rest)
    # order: (dy, dx) -> d0=(0,0), d1=(0,1)=x+1, d2=(1,0)=y+1, d3=(1,1)
    return jnp.stack(
        [q[:, 0, :, 0], q[:, 0, :, 1], q[:, 1, :, 0], q[:, 1, :, 1]],
        axis=2,
    )


@register("downsample_gbuffer")
def downsample_gbuffer(depth, normal, velocity):
    """Full-res -> half-res (depth min + argmin-selected normal/velocity).

    downsample_gbuffer.frag: min_depth = min(d0..d3); the FIRST quad texel
    equal to the min (in order d0, d1, d2, d3) provides normal/velocity.
    """
    dq = _quads(depth)              # (h, w, 4)
    min_depth = dq.min(axis=2)
    # The frag's if/else chain checks d1, d2, d3 and falls back to d0, so
    # on ties the priority order is d1 > d2 > d3 > d0.
    prio = jnp.stack([dq[..., 1], dq[..., 2], dq[..., 3], dq[..., 0]],
                     axis=2)
    first_prio = jnp.argmax(prio == min_depth[..., None], axis=2)
    first = jnp.asarray([1, 2, 3, 0], jnp.int32)[first_prio]
    nq = _quads(normal)             # (h, w, 4, 2)
    vq = _quads(velocity)
    pick = first[..., None, None]
    normal_half = jnp.take_along_axis(nq, pick, 2)[:, :, 0]
    velocity_half = jnp.take_along_axis(vq, pick, 2)[:, :, 0]
    return min_depth, normal_half, velocity_half


@register("depth_mips")
@register("downsample_depth")  # manifest name (config.json: depth_downsample/*)
def downsample_depth_chain(depth_half) -> List[jnp.ndarray]:
    """Mips 2..N by 2x2 min (depth_downsample/shader.frag), down to 1x1-ish.

    Odd extents truncate (the reference renders to mip extents w>>i, whose
    out-of-range texelFetches clamp; truncation keeps the min conservative).
    """
    mips = []
    cur = depth_half
    while min(cur.shape) > 1:
        h, w = cur.shape
        h2, w2 = h // 2, w // 2
        cur = cur[: h2 * 2, : w2 * 2]
        q = _quads(cur)
        cur = q.min(axis=2)
        mips.append(cur)
    return mips


@register("downsample_hiz")
def build_hiz(depth, normal, velocity) -> HiZPyramid:
    """The full DownsampleGbuffer + DownsampleDepth chain
    (downsample_pass.cpp run())."""
    d1, n_half, v_half = downsample_gbuffer(depth, normal, velocity)
    rest = downsample_depth_chain(d1)
    return HiZPyramid(
        mips=tuple([d1] + rest), normal_half=n_half, velocity_half=v_half
    )
