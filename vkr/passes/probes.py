"""Octahedral light-probe renderer + probe-grid reflection trace.

Reference: src/probe_renderer.{hpp,cpp} + shaders/{cubemap_probe,cube2oct,
probe_downsample,trace_probe}. Pipeline:
  1. render_probe: raster the scene 6x from the probe position (90deg fov,
     CUBE_SIZE=128) into albedo color + view distance (cubemap_probe
     shaders; the reference's raster task is commented out pending its
     bindless port, probe_renderer.cpp:104-168 — rebuilt here on the Pallas
     rasterizer);
  2. cube_to_oct: resample the cubemap to a PROBE_SIZE=256 octahedral map
     and encode per-texel planar depth along the octant diagonal
     (cube2oct/shader.comp, octahedral.glsl);
  3. min-downsample the oct depth into a mip pyramid (probe_downsample);
  4. probe_trace: per G-buffer pixel, reflect and hierarchically march the
     probe-grid's octahedral depth maps in up to 4 octant segments across
     up to 4 neighboring probes (trace_probe/shader.comp).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from vkr.mathlib.transforms import transform_points
from vkr.mathlib.octahedral import oct_decode_dir, oct_encode_dir
from vkr.mathlib.projection import reconstruct_view_vec
from vkr.mathlib.transforms import look_at, perspective
from vkr.mathlib.octahedral import decode_normal
from vkr.passes.sampling import bilinear_sample, screen_uv_grid

from vkr.core.registry import register

ZNEAR = 0.05   # cube2oct/shader.comp:10
ZFAR = 80.0
TRACE_STEPS = 25
MAX_T = 3.402823466e38

# Vulkan cubemap face (look, up) conventions.
_FACES = [
    ((1, 0, 0), (0, -1, 0)),
    ((-1, 0, 0), (0, -1, 0)),
    ((0, 1, 0), (0, 0, 1)),
    ((0, -1, 0), (0, 0, -1)),
    ((0, 0, 1), (0, -1, 0)),
    ((0, 0, -1), (0, -1, 0)),
]


def encode_oct_depth(z, n=ZNEAR, f=ZFAR):
    """octahedral.glsl:70-72 (planar depth along the octant diagonal)."""
    return f / (f - n) + f * n / ((-z) * (f - n))


def decode_oct_depth(d, n=ZNEAR, f=ZFAR):
    return -n * f / (d * (f - n) - f)


def oct_center(uv):
    """octahedral.glsl oct_center: the octant diagonal direction."""
    u = 2.0 * (uv - 0.5)
    z = 1.0 - jnp.abs(u[..., 0]) - jnp.abs(u[..., 1])
    v = jnp.concatenate([u, z[..., None]], axis=-1)
    s = jnp.where(v >= 0.0, 1.0, -1.0)
    # sign(0) = 0 in GLSL sign(); match it for exact parity
    s = jnp.where(v == 0.0, 0.0, s)
    return s / jnp.linalg.norm(s, axis=-1, keepdims=True).clip(1e-20)


class Probe(NamedTuple):
    color: jnp.ndarray            # (S, S, 3) octahedral albedo
    depth_mips: Tuple[jnp.ndarray, ...]  # oct depth pyramid, base first


@register("cubemap_probe")
def render_probe_cubemap(scene, position, cube_size: int = 128,
                         use_pallas: bool = True, interpret: bool = False):
    """Raster the scene 6x from `position`. Returns (color (6, S, S, 3),
    distance (6, S, S))."""
    from vkr.passes.gbuffer import render_gbuffer

    proj = perspective(math.radians(90.0), 1.0, ZNEAR, ZFAR)
    colors, dists = [], []
    pos = np.asarray(position, np.float32)
    for look, up in _FACES:
        view = look_at(pos, pos + np.asarray(look, np.float32),
                       np.asarray(up, np.float32))
        vp = jnp.asarray(proj @ view)
        g = render_gbuffer(
            scene, vp, vp, jnp.zeros(2, jnp.float32),
            width=cube_size, height=cube_size, quantize=False,
            use_pallas=use_pallas, interpret=interpret,
        )
        uv = screen_uv_grid(cube_size, cube_size)
        view_pos = reconstruct_view_vec(
            uv, g.depth, math.radians(90.0), 1.0, ZNEAR, ZFAR
        )
        dist = jnp.linalg.norm(view_pos, axis=-1)
        # clear color 100 for both attachments (probe_renderer.cpp:135)
        bg = g.depth >= 1.0
        color = jnp.where(bg[..., None],
                          jnp.asarray([100.0, 0.0, 0.0]),
                          g.albedo[..., :3])
        dist = jnp.where(bg, 100.0, dist)
        colors.append(color)
        dists.append(dist)
    return jnp.stack(colors), jnp.stack(dists)


def sample_cubemap(faces, direction):
    """samplerCube lookup: face select + bilinear within the face.

    faces: (6, S, S, C) in _FACES order; direction: (..., 3).
    """
    x, y, z = direction[..., 0], direction[..., 1], direction[..., 2]
    ax, ay, az = jnp.abs(x), jnp.abs(y), jnp.abs(z)

    # face index by dominant axis
    is_x = (ax >= ay) & (ax >= az)
    is_y = (~is_x) & (ay >= az)
    face = jnp.where(
        is_x, jnp.where(x > 0, 0, 1),
        jnp.where(is_y, jnp.where(y > 0, 2, 3), jnp.where(z > 0, 4, 5)),
    )
    ma = jnp.where(is_x, ax, jnp.where(is_y, ay, az)).clip(1e-20)
    # standard cubemap (s, t) per face
    sc = jnp.where(
        is_x, jnp.where(x > 0, -z, z),
        jnp.where(is_y, x, jnp.where(z > 0, x, -x)),
    )
    tc = jnp.where(
        is_x, -y, jnp.where(is_y, jnp.where(y > 0, z, -z), -y)
    )
    uv = jnp.stack([(sc / ma + 1.0) * 0.5, (tc / ma + 1.0) * 0.5], -1)

    taps = jnp.stack(
        [bilinear_sample(faces[i], uv) for i in range(6)], axis=0
    )
    sel = face[None, ..., None] if faces.ndim == 4 else face[None]
    out = jnp.take_along_axis(
        taps, jnp.broadcast_to(sel, (1,) + taps.shape[1:]), axis=0
    )[0]
    return out


@register("cube2oct")
def cube_to_oct(color_faces, dist_faces, oct_size: int = 256):
    """cube2oct/shader.comp: octahedral resample + planar depth encode.

    NOTE: the shader uses uv = pixel/size (no half-texel offset)."""
    xs = jnp.arange(oct_size, dtype=jnp.float32) / oct_size
    uv = jnp.stack(jnp.meshgrid(xs, xs), axis=-1)
    direction = oct_decode_dir(uv)
    color = sample_cubemap(color_faces, direction)
    dist = sample_cubemap(dist_faces[..., None], direction)[..., 0]
    view_dir = direction * dist[..., None]
    front = oct_center(uv)
    # planar depth along the octant diagonal — POSITIVE distance, like
    # the reference (cube2oct/shader.comp:27: encode_oct_depth(dot, n, f)
    # with dot > 0 mapping near->0, far->1)
    depth = encode_oct_depth(
        jnp.clip((view_dir * front).sum(-1), ZNEAR, ZFAR)
    )
    return color, depth


@register("probe_downsample")
def oct_depth_pyramid(oct_depth) -> Tuple[jnp.ndarray, ...]:
    """probe_downsample: min 2x2 chain."""
    mips = [oct_depth]
    cur = oct_depth
    while min(cur.shape) > 1:
        h, w = cur.shape
        cur = cur[: h // 2 * 2, : w // 2 * 2]
        cur = cur.reshape(h // 2, 2, w // 2, 2).min(axis=(1, 3))
        mips.append(cur)
    return tuple(mips)


def render_probe(scene, position, cube_size: int = 128,
                 oct_size: int = 256, use_pallas: bool = True,
                 interpret: bool = False) -> Probe:
    """ProbeRenderer::render_probe: cubemap -> octahedral map + depth mips."""
    color_faces, dist_faces = render_probe_cubemap(
        scene, position, cube_size, use_pallas, interpret
    )
    color, depth = cube_to_oct(color_faces, dist_faces, oct_size)
    return Probe(color=color, depth_mips=oct_depth_pyramid(depth))


class ProbeGrid(NamedTuple):
    """OctahedralProbeGrid (probe_renderer.cpp:251-288): grid_size^2 probes
    on the y-plane between probe_min and probe_max."""

    colors: jnp.ndarray           # (P, S, S, 3)
    depth_flat: jnp.ndarray       # (P, sum mip texels) packed pyramids
    mip_offsets: Tuple[int, ...]
    mip_sizes: Tuple[int, ...]
    probe_min: jnp.ndarray        # (3,)
    probe_max: jnp.ndarray        # (3,)
    grid_size: int


def render_probe_grid(scene, probe_min, probe_max, grid_size: int,
                      cube_size: int = 128, oct_size: int = 256,
                      use_pallas: bool = True,
                      interpret: bool = False) -> ProbeGrid:
    pmin = np.asarray(probe_min, np.float32)
    pmax = np.asarray(probe_max, np.float32)
    step = (pmax - pmin) / max(grid_size - 1, 1)
    colors, flats = [], []
    offsets, sizes = None, None
    for y in range(grid_size):
        for x in range(grid_size):
            pos = pmin + np.array([x, 0, y], np.float32) * step
            probe = render_probe(scene, pos, cube_size, oct_size,
                                 use_pallas, interpret)
            colors.append(probe.color)
            if offsets is None:
                offsets, sizes, off = [], [], 0
                for m in probe.depth_mips:
                    offsets.append(off)
                    sizes.append(int(m.shape[0]))
                    off += m.shape[0] * m.shape[1]
            flats.append(
                jnp.concatenate([m.reshape(-1) for m in probe.depth_mips])
            )
    return ProbeGrid(
        colors=jnp.stack(colors),
        depth_flat=jnp.stack(flats),
        mip_offsets=tuple(offsets),
        mip_sizes=tuple(sizes),
        probe_min=jnp.asarray(pmin),
        probe_max=jnp.asarray(pmax),
        grid_size=grid_size,
    )


def _fetch_probe_depth(grid: ProbeGrid, probe_idx, mip, x, y):
    offs = jnp.asarray(grid.mip_offsets, jnp.int32)[mip]
    s = jnp.asarray(grid.mip_sizes, jnp.int32)[mip]
    xi = jnp.clip(x, 0, s - 1)
    yi = jnp.clip(y, 0, s - 1)
    flat_idx = offs + yi * s + xi
    stride = grid.depth_flat.shape[1]
    return jnp.take(
        grid.depth_flat.reshape(-1),
        jnp.clip(probe_idx, 0, grid.colors.shape[0] - 1) * stride
        + flat_idx,
    )


def _probe_march(grid, probe_idx, origin, direction, max_iters):
    """hierarchical_raymarch over a probe's oct depth pyramid
    (trace_probe/shader.comp:218-268; t clamped to 1)."""
    base = float(grid.mip_sizes[0])
    n_mips = len(grid.mip_sizes)
    inv_dir = jnp.where(
        direction != 0.0, 1.0 / jnp.where(direction == 0, 1.0, direction),
        MAX_T,
    )
    uv_off_mag = 0.005 / base
    uv_offset = jnp.where(direction[..., :2] < 0, -uv_off_mag, uv_off_mag)
    floor_offset = jnp.where(direction[..., :2] < 0, 0.0, 1.0)

    cur_pos = base * origin[..., :2]
    xy_plane = (jnp.floor(cur_pos) + floor_offset) / base + uv_offset
    t0 = (xy_plane - origin[..., :2]) * inv_dir[..., :2]
    current_t = jnp.minimum(t0[..., 0], t0[..., 1])
    position = origin + current_t[..., None] * direction

    shape = origin.shape[:-1]
    st = dict(
        position=position, current_t=current_t,
        mip=jnp.zeros(shape, jnp.int32),
        done=jnp.zeros(shape, bool),
        iters=jnp.zeros(shape, jnp.int32),
    )

    def body(i, st):
        mip = st["mip"]
        mip_res = base * jnp.exp2(-mip.astype(jnp.float32))
        mip_pos = mip_res[..., None] * st["position"][..., :2]
        surface_z = _fetch_probe_depth(
            grid, probe_idx, jnp.clip(mip, 0, n_mips - 1),
            mip_pos[..., 0].astype(jnp.int32),
            mip_pos[..., 1].astype(jnp.int32),
        )
        xy_plane = (
            (jnp.floor(mip_pos) + floor_offset) / mip_res[..., None]
            + uv_offset
        )
        t_xy = (xy_plane - origin[..., :2]) * inv_dir[..., :2]
        t_z = (surface_z - origin[..., 2]) * inv_dir[..., 2]
        t_z = jnp.where(direction[..., 2] > 0, t_z, MAX_T)
        t_min = jnp.minimum(
            jnp.minimum(jnp.minimum(t_xy[..., 0], t_xy[..., 1]), t_z), 1.0
        )
        above = surface_z > st["position"][..., 2]
        skipped = (t_min != t_z) & above
        new_t = jnp.clip(jnp.where(above, t_min, st["current_t"]),
                         -1e20, 1e20)
        new_pos = origin + new_t[..., None] * direction
        new_mip = mip + jnp.where(skipped, 1, -1)
        act = ~st["done"]
        return dict(
            position=jnp.where(act[..., None], new_pos, st["position"]),
            current_t=jnp.where(act, new_t, st["current_t"]),
            mip=jnp.where(act, new_mip, mip),
            done=st["done"] | (new_mip < 0),
            iters=jnp.where(act, i + 1, st["iters"]),
        )

    st = jax.lax.fori_loop(0, max_iters, body, st)
    iters = jnp.where(st["done"], st["iters"], max_iters + 1)
    pos = jnp.where(jnp.isfinite(st["position"]), st["position"], 0.0)
    return jnp.clip(pos, -1e6, 1e6), iters <= max_iters


def _trace_segment(grid, probe_idx, ray_origin, ray_dir, t0, t1):
    """trace_segment_hi (trace_probe/shader.comp:270-323).

    Returns (result code 0=miss 1=hit 2=unknown, hit oct uv)."""
    eps = 0.001
    p_start3 = ray_origin + ray_dir * (t0 + eps)[..., None]
    p_end3 = ray_origin + ray_dir * (t1 - eps)[..., None]
    degenerate = ((p_end3 - p_start3) ** 2).sum(-1) < 0.001
    p_start3 = jnp.where(degenerate[..., None], ray_dir, p_start3)

    def norm(v):
        return v / jnp.linalg.norm(v, axis=-1, keepdims=True).clip(1e-20)

    start_oct = oct_encode_dir(norm(p_start3))
    end_oct = oct_encode_dir(norm(p_end3))
    front = oct_center(0.5 * (start_oct + end_oct))

    # positive planar distances (trace_probe/shader.comp:291-293)
    start_depth = encode_oct_depth(
        jnp.maximum((p_start3 * front).sum(-1), 1e-6)
    ) - 0.0005
    end_depth = encode_oct_depth(
        jnp.maximum((p_end3 * front).sum(-1), 1e-6)
    )
    p_start = jnp.concatenate([start_oct, start_depth[..., None]], -1)
    p_end = jnp.concatenate([end_oct, end_depth[..., None]], -1)

    p_stop, valid = _probe_march(grid, probe_idx, p_start,
                                 p_end - p_start, TRACE_STEPS)
    sampled = _fetch_probe_depth(
        grid, probe_idx, jnp.zeros_like(probe_idx),
        (p_stop[..., 0] * grid.mip_sizes[0]).astype(jnp.int32),
        (p_stop[..., 1] * grid.mip_sizes[0]).astype(jnp.int32),
    )
    bias = 0.0005
    result = jnp.where(
        ~valid, 0,
        jnp.where(
            p_stop[..., 2] > 1.0, 0,
            jnp.where(
                p_stop[..., 2] > sampled + bias, 2,
                jnp.where(p_stop[..., 2] > sampled - bias, 1, 0),
            ),
        ),
    )
    return result, p_stop[..., :2]


def _segments(origin, inv_dir, tmin, tmax):
    """compute_trace_segments: split the ray at octant plane crossings."""
    t = -origin * inv_dir
    t = jnp.sort(t, axis=-1)
    b1 = jnp.clip(t[..., 0], tmin, tmax)
    b2 = jnp.clip(t[..., 1], tmin, tmax)
    b3 = jnp.clip(t[..., 2], tmin, tmax)
    return [jnp.full_like(b1, tmin), b1, b2, b3,
            jnp.full_like(b1, tmax)]


@register("trace_probe")
def probe_trace(depth, normal_oct, grid: ProbeGrid, inverse_view,
                fovy, aspect, znear, zfar, row0=None,
                band_h: "int | None" = None):
    """ProbeTracePass: per-pixel probe-grid reflection
    (trace_probe/shader.comp main + trace over neighbor probes).

    row0/band_h (band mode): compute only rows [row0, row0 + band_h)."""
    H, W = depth.shape
    banded = row0 is not None
    h = band_h if banded else H
    w = W
    uv = screen_uv_grid(h, w, row0=row0 if banded else 0, full_height=H)
    if banded:
        depth = jax.lax.dynamic_slice(depth, (row0, 0), (h, W))
        normal_oct = jax.lax.dynamic_slice(
            normal_oct, (row0, 0, 0), (h, W, normal_oct.shape[2]))
    view_vec = reconstruct_view_vec(uv, depth, fovy, aspect, znear, zfar)
    inv = jnp.asarray(inverse_view)
    n = decode_normal(normal_oct)
    world_pos = transform_points(view_vec, inv)
    world_pos = world_pos + 1e-6 * n
    cam = inv[:3, 3]
    v = world_pos - cam[None, None, :]
    v = v / jnp.linalg.norm(v, axis=-1, keepdims=True).clip(1e-20)
    world_pos = world_pos - 1e-6 * v
    r = v - 2.0 * (v * n).sum(-1, keepdims=True) * n

    gs = grid.grid_size
    pstep = (grid.probe_max - grid.probe_min) / max(gs - 1, 1)
    coord = jnp.clip(
        (world_pos - grid.probe_min[None, None, :])
        / jnp.where(jnp.abs(pstep) < 1e-9, 1.0, pstep)[None, None, :],
        0.0, gs - 2 if gs > 1 else 0,
    )
    sx = jnp.floor(coord[..., 0]).astype(jnp.int32)
    sy = jnp.floor(coord[..., 2]).astype(jnp.int32)
    start_probe = sy * gs + sx

    reflection = jnp.zeros((h, w, 4), jnp.float32)
    settled = jnp.zeros((h, w), bool)

    n_neighbors = 4 if gs > 1 else 1
    for i in range(n_neighbors):
        dx, dy = i & 1, (i >> 1) & 1
        probe_idx = jnp.clip((sy + dy) * gs + (sx + dx), 0, gs * gs - 1)
        ppos = (
            grid.probe_min[None, None, :]
            + jnp.stack(
                [(sx + dx).astype(jnp.float32),
                 jnp.zeros_like(sx, jnp.float32),
                 (sy + dy).astype(jnp.float32)], -1,
            ) * pstep[None, None, :]
        )
        origin = world_pos - ppos
        rd = r
        inv_rd = jnp.where(rd != 0.0,
                           1.0 / jnp.where(rd == 0, 1.0, rd), MAX_T)
        bounds = _segments(origin, inv_rd, 1e-6, 30.0)
        for s in range(4):
            seg_ok = jnp.abs(bounds[s + 1] - bounds[s]) >= 0.002
            res, hit_uv = _trace_segment(
                grid, probe_idx, origin, rd, bounds[s], bounds[s + 1]
            )
            hit = (res == 1) & seg_ok & ~settled
            col = _sample_probe_color(grid, probe_idx, hit_uv)
            reflection = jnp.where(
                hit[..., None],
                jnp.concatenate([col, jnp.ones((h, w, 1))], -1),
                reflection,
            )
            settled = settled | (hit | ((res == 2) & seg_ok & ~settled))

    return jnp.where((depth >= 1.0)[..., None], 0.0, reflection)


def _sample_probe_color(grid: ProbeGrid, probe_idx, uv):
    """Bilinear sample of (P, S, S, 3) with per-pixel probe index."""
    p, s, _, c = grid.colors.shape
    flat = grid.colors.reshape(p * s * s, c)
    x = uv[..., 0] * s - 0.5
    y = uv[..., 1] * s - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0 = x0.astype(jnp.int32)
    y0 = y0.astype(jnp.int32)
    base = jnp.clip(probe_idx, 0, p - 1) * s * s

    def tap(xi, yi):
        xi = jnp.clip(xi, 0, s - 1)
        yi = jnp.clip(yi, 0, s - 1)
        return jnp.take(flat, base + yi * s + xi, axis=0)

    top = tap(x0, y0) * (1 - fx) + tap(x0 + 1, y0) * fx
    bot = tap(x0, y0 + 1) * (1 - fx) + tap(x0 + 1, y0 + 1) * fx
    return top * (1 - fy) + bot * fy
