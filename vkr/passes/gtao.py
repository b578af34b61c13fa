"""GTAO — ground-truth ambient occlusion (horizon-based), half resolution.

Reference: src/gtao.cpp + shaders/gtao/{main,filter,accum}.comp. The default
path is gtao_camera_space (main.comp:195-225): per pixel, march the half-res
depth along a per-pixel screen-space direction (deterministic 4x4 dither
pattern + per-frame angle offset, main.comp:292-294), track the max horizon
cosine with a thickness break (MAX_THIKNESS=0.1), then integrate the GTAO
arc term; then a 4x4 depth-bilateral filter and a velocity-reprojected
temporal accumulation with world-space validation.

Two implementations of the main pass:
  * gtao_main_exact — faithful gather-based port (bilinear depth taps at
    fractional uv); the production pass ("gtao_main").
  * gtao_main_dense — gather-free variant: 16 direction classes x 16
    integer-pixel march steps, each step a dynamic-slice shift of the
    padded depth image. Sample placement differs from the reference
    (integer-pixel steps up to the radius instead of 16 fractional steps
    across it — at least as dense for radii <= 16 px, the reference clamp);
    AO quality is equivalent, noise pattern matches the same dither classes.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from vkr.mathlib.transforms import apply_linear, transform_points
from vkr.mathlib.octahedral import decode_normal
from vkr.mathlib.projection import (
    linearize_depth,
    reconstruct_view_vec,
)
from vkr.passes.sampling import bilinear_sample, screen_uv_grid

from vkr.core.registry import register

PI = math.pi
MAX_THICKNESS = 0.1   # main.comp MAX_THIKNESS
N_STEPS = 16          # find_horizon(..., 16, w0) in gtao_camera_space
N_CLASSES = 16        # 4x4 dither pattern period

# Per-frame angle offsets (gtao.cpp:109-111). The reference adds libc
# rand()-0.5; we use a deterministic hash of the frame index instead.
ANGLE_OFFSETS = jnp.asarray(
    [60.0, 300.0, 180.0, 240.0, 120.0, 0.0,
     300.0, 60.0, 180.0, 120.0, 240.0, 0.0], jnp.float32
) / 360.0


def frame_base_angle(frame_index):
    """base_angle = table[frame % 12] + (hash-random in [-0.5, 0.5))."""
    offset = ANGLE_OFFSETS[frame_index % 12]
    h = frame_index.astype(jnp.uint32) * jnp.uint32(2654435761) + jnp.uint32(
        1013904223
    )
    rnd = (h >> 8).astype(jnp.float32) / float(1 << 24) - 0.5
    return offset + rnd


def gtao_direction_pattern(height: int, width: int, row0=0):
    """main.comp:292-294: (1/16) * ((((x+y)&3)<<2) + (x&3)), per pixel.
    row0 (band mode): y indices are global rows row0 + i."""
    x = jnp.arange(width, dtype=jnp.int32)[None, :]
    y = (row0 + jnp.arange(height, dtype=jnp.int32))[:, None]
    cls = ((((x + y) & 3) << 2) + (x & 3))
    return cls  # int class in [0, 16); pattern value = cls / 16


class GTAOParams(NamedTuple):
    normal_mat: jnp.ndarray   # (4,4) world->view normal matrix
    fovy: float
    aspect: float
    znear: float
    zfar: float


def _arc_terms(uv, frag_depth, camera_pos, w0, camera_normal, dir_xy,
               params):
    """Slice-projected normal terms shared by both modes
    (gtao_camera_space, main.comp:203-211)."""
    sample_end = reconstruct_view_vec(
        uv + dir_xy, frag_depth, params.fovy, params.aspect,
        params.znear, params.zfar,
    )
    slice_n = jnp.cross(w0, -sample_end)
    slice_n = slice_n / jnp.linalg.norm(slice_n, axis=-1,
                                        keepdims=True).clip(1e-20)
    n_proj = camera_normal - (
        (camera_normal * slice_n).sum(-1, keepdims=True) * slice_n
    )
    n_proj_len = jnp.linalg.norm(n_proj, axis=-1).clip(1e-20)
    x_axis = -jnp.cross(slice_n, w0)
    x_axis = x_axis / jnp.linalg.norm(x_axis, axis=-1,
                                      keepdims=True).clip(1e-20)
    cos_n = ((n_proj / n_proj_len[..., None]) * x_axis).sum(-1)
    n_angle = PI / 2.0 - jnp.arccos(jnp.clip(cos_n, -1.0, 1.0))
    return n_proj_len, n_angle


def _arc_integral(h_cos, n_proj_len, n_angle):
    h = jnp.arccos(jnp.clip(h_cos, -1.0, 1.0))
    h = jnp.minimum(n_angle + jnp.minimum(h - n_angle, PI / 2.0), h)
    return n_proj_len * 0.25 * jnp.maximum(
        -jnp.cos(2.0 * h - n_angle) + jnp.cos(n_angle)
        + 2.0 * h * jnp.sin(n_angle), 0.0,
    )


def _common(depth_half, normal_half, params, row0=None,
            band_h=None):
    """Shared per-pixel terms. row0/band_h (band mode): compute only
    rows [row0, row0 + band_h); returns the CENTER depth slice too."""
    H, W = depth_half.shape
    banded = row0 is not None
    h = band_h if banded else H
    uv = screen_uv_grid(h, W, row0=row0 if banded else 0, full_height=H)
    if banded:
        depth_c = jax.lax.dynamic_slice(depth_half, (row0, 0), (h, W))
        normal_c = jax.lax.dynamic_slice(
            normal_half, (row0, 0, 0), (h, W, normal_half.shape[2]))
    else:
        depth_c = depth_half
        normal_c = normal_half
    camera_pos = reconstruct_view_vec(
        uv, depth_c, params.fovy, params.aspect, params.znear,
        params.zfar,
    )
    w0 = -camera_pos / jnp.linalg.norm(camera_pos, axis=-1,
                                       keepdims=True).clip(1e-20)
    nm = jnp.asarray(params.normal_mat)
    world_n = decode_normal(normal_c)
    cam_n = apply_linear(world_n, nm[:3, :3])
    cam_n = cam_n / jnp.linalg.norm(cam_n, axis=-1,
                                    keepdims=True).clip(1e-20)
    # dir_radius in pixels: min(100/|campos|, 16) (gtao_camera_space)
    radius_px = jnp.minimum(
        100.0 / jnp.linalg.norm(camera_pos, axis=-1).clip(1e-20), 16.0
    )
    return uv, camera_pos, w0, cam_n, radius_px, depth_c


@register("gtao_compute_main")
def gtao_main_exact(depth_half, normal_half, params: GTAOParams,
                    base_angle, dirs_count: int = 1, row0=None,
                    band_h: "int | None" = None):
    """Faithful gather-based port of gtao_camera_space.

    row0/band_h (band mode): compute only rows [row0, row0 + band_h);
    depth_half stays FULL (the horizon march samples globally)."""
    H, W = depth_half.shape
    uv, camera_pos, w0, cam_n, radius_px, depth_c = _common(
        depth_half, normal_half, params, row0=row0, band_h=band_h
    )
    h, w = depth_c.shape
    cls = gtao_direction_pattern(h, w, row0=0 if row0 is None else row0
                                 ).astype(jnp.float32) / 16.0
    size = jnp.asarray([W, H], jnp.float32)

    total = jnp.zeros((h, w), jnp.float32)
    for d in range(dirs_count):
        angle = 2.0 * PI * (cls + base_angle + d / dirs_count)
        dir_uv = (
            radius_px[..., None]
            * jnp.stack([jnp.cos(angle), jnp.sin(angle)], -1) / size
        )
        n_proj_len, n_angle = _arc_terms(
            uv, depth_c, camera_pos, w0, cam_n, dir_uv, params
        )

        def step(i, carry):
            h_cos, prev_z, alive = carry
            tc = uv + (i.astype(jnp.float32) / N_STEPS) * dir_uv
            sd = bilinear_sample(depth_half, tc)
            sp = reconstruct_view_vec(tc, sd, params.fovy, params.aspect,
                                      params.znear, params.zfar)
            alive = alive & ~(sp[..., 2] > prev_z + MAX_THICKNESS)
            prev_z = jnp.where(alive, sp[..., 2], prev_z)
            off = sp - camera_pos
            s_cos = (w0 * off).sum(-1) / jnp.linalg.norm(
                off, axis=-1).clip(1e-20)
            h_cos = jnp.where(alive, jnp.maximum(h_cos, s_cos), h_cos)
            return h_cos, prev_z, alive

        h_cos, _, _ = jax.lax.fori_loop(
            1, N_STEPS + 1, step,
            (jnp.full((h, w), -1.0), camera_pos[..., 2],
             jnp.ones((h, w), bool)),
        )
        total = total + _arc_integral(h_cos, n_proj_len, n_angle)

    ao = 2.0 * total / dirs_count
    return jnp.where(depth_c >= 1.0, 0.0, ao)


# The production main pass is the exact gather port: on the GPU each of
# its 16 bilinear taps is an ordinary cached load that XLA fuses.
gtao_main = register("gtao_main")(gtao_main_exact)


@register("gtao_main_dense")
def gtao_main_dense(depth_half, normal_half, params: GTAOParams,
                    base_angle, dirs_count: int = 1, row0=None,
                    band_h: "int | None" = None):
    """Gather-free dense GTAO: per direction class, march integer-pixel
    offsets via dynamic slices of the padded depth image.

    row0/band_h (band mode): compute only rows [row0, row0 + band_h);
    depth_half stays FULL (the march slices shift within the N_STEPS
    halo around the band)."""
    H, W = depth_half.shape
    uv, camera_pos, w0, cam_n, radius_px, depth_c = _common(
        depth_half, normal_half, params, row0=row0, band_h=band_h
    )
    h, w = depth_c.shape
    cls_img = gtao_direction_pattern(h, w,
                                     row0=0 if row0 is None else row0)
    size = jnp.asarray([W, H], jnp.float32)

    pad = N_STEPS
    dep_pad = jnp.pad(depth_half, pad, mode="edge")
    if row0 is not None:
        # band + N_STEPS halo of the padded full image
        dep_pad = jax.lax.dynamic_slice(dep_pad, (row0, 0),
                                        (h + 2 * pad, W + 2 * pad))

    total = jnp.zeros((h, w), jnp.float32)
    for d in range(dirs_count):
        def class_body(c, ao_d, d=d):
            angle = 2.0 * PI * (
                c.astype(jnp.float32) / 16.0 + base_angle + d / dirs_count
            )
            ca, sa = jnp.cos(angle), jnp.sin(angle)
            dir_uv = radius_px[..., None] * jnp.stack(
                [jnp.broadcast_to(ca, (h, w)),
                 jnp.broadcast_to(sa, (h, w))], -1) / size
            n_proj_len, n_angle = _arc_terms(
                uv, depth_c, camera_pos, w0, cam_n, dir_uv, params
            )

            def step(j, carry, ca=ca, sa=sa):
                h_cos, prev_z, alive = carry
                jf = j.astype(jnp.float32)
                ox = jnp.round(jf * ca).astype(jnp.int32)
                oy = jnp.round(jf * sa).astype(jnp.int32)
                sd = jax.lax.dynamic_slice(
                    dep_pad, (pad + oy, pad + ox), (h, w)
                )
                tc = uv + jnp.stack(
                    [jnp.broadcast_to(ox.astype(jnp.float32), (h, w)),
                     jnp.broadcast_to(oy.astype(jnp.float32), (h, w))],
                    -1,
                ) / size
                sp = reconstruct_view_vec(
                    tc, sd, params.fovy, params.aspect, params.znear,
                    params.zfar,
                )
                in_r = jf <= radius_px
                step_alive = alive & in_r
                broken = sp[..., 2] > prev_z + MAX_THICKNESS
                step_alive = step_alive & ~broken
                alive = alive & ~(in_r & broken)
                prev_z = jnp.where(step_alive, sp[..., 2], prev_z)
                off = sp - camera_pos
                s_cos = (w0 * off).sum(-1) / jnp.linalg.norm(
                    off, axis=-1).clip(1e-20)
                h_cos = jnp.where(step_alive,
                                  jnp.maximum(h_cos, s_cos), h_cos)
                return h_cos, prev_z, alive

            h_cos, _, _ = jax.lax.fori_loop(
                1, N_STEPS + 1, step,
                (jnp.full((h, w), -1.0), camera_pos[..., 2],
                 jnp.ones((h, w), bool)),
            )
            arc = _arc_integral(h_cos, n_proj_len, n_angle)
            return jnp.where(cls_img == c, arc, ao_d)

        ao_d = jax.lax.fori_loop(
            0, N_CLASSES, class_body, jnp.zeros((h, w), jnp.float32)
        )
        total = total + ao_d

    ao = 2.0 * total / dirs_count
    return jnp.where(depth_c >= 1.0, 0.0, ao)


def ao_ray_directions(count: int = 64, seed: int = 7):
    """The reference's fixed hemisphere direction set
    (gtao.cpp:415-440): rejection-sample uniform unit vectors with
    z >= 0 once per run. Its std::default_random_engine stream is
    replaced by a seeded numpy RNG — same distribution, deterministic,
    like frame_base_angle's rand() replacement."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    while len(out) < count:
        v = rng.uniform(-1.0, 1.0, 3)
        v[2] = abs(v[2])
        n = float(np.linalg.norm(v))
        if n <= 1e-5 or n > 1.0:
            continue
        out.append(v / n)
    return np.asarray(out, np.float32)


@register("gtao_rt")
@register("gtao_rt_main")  # manifest name (config.json: gtao/rt_main_frag)
def gtao_rt(depth_half, normal_half, tri_grid, camera_to_world,
            fovy, aspect, znear, zfar, rotation, directions,
            rt_radius: float = 0.2, max_steps: int = 12,
            dir_chunk: int = 8, row0=None,
            band_h: "int | None" = None):
    """Ray-traced GTAO (shaders/gtao/rt_main.frag): per half-res pixel,
    trace the fixed hemisphere direction set (rotated into the surface
    frame by the per-pixel dither angle + per-frame rotation) against
    the scene acceleration structure; AO = 2 * mean(visibility * NdotL).

    tri_grid: scene.accel.TriGrid (the TLAS analog); directions:
    (N, 3) from ao_ray_directions. Opt-in behind
    cfg.gtao.use_ray_query, like the reference's USE_RAY_QUERY.

    row0/band_h (band mode): compute only rows [row0, row0 + band_h)."""
    from vkr.scene.accel import ray_any_hit

    H, W = depth_half.shape
    banded = row0 is not None
    h = band_h if banded else H
    w = W
    uv = screen_uv_grid(h, w, row0=row0 if banded else 0, full_height=H)
    if banded:
        depth_c = jax.lax.dynamic_slice(depth_half, (row0, 0), (h, W))
        normal_c = jax.lax.dynamic_slice(
            normal_half, (row0, 0, 0), (h, W, normal_half.shape[2]))
    else:
        depth_c = depth_half
        normal_c = normal_half

    view_vec = reconstruct_view_vec(uv, depth_c, fovy, aspect, znear,
                                    zfar)
    c2w = jnp.asarray(camera_to_world)
    world_pos = transform_points(view_vec, c2w)
    n = decode_normal(normal_c)
    world_pos = world_pos + 1e-6 * n

    # tangent frame + per-pixel dither rotation (rt_main.frag:47-86)
    max_xy = jnp.maximum(jnp.abs(n[..., 0]), jnp.abs(n[..., 1]))
    t = jnp.where(
        (max_xy < 1e-5)[..., None],
        jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0]), n.shape),
        jnp.stack([n[..., 1], -n[..., 0], jnp.zeros_like(max_xy)], -1),
    )
    t = t / jnp.linalg.norm(t, axis=-1, keepdims=True).clip(1e-20)
    b = jnp.cross(n, t)
    b = b / jnp.linalg.norm(b, axis=-1, keepdims=True).clip(1e-20)
    t = jnp.cross(b, n)
    cls = gtao_direction_pattern(
        h, w, row0=0 if row0 is None else row0
    ).astype(jnp.float32) / 16.0
    angle = 2.0 * PI * (rotation + cls)
    t = jnp.cos(angle)[..., None] * t + jnp.sin(angle)[..., None] * b
    t = t / jnp.linalg.norm(t, axis=-1, keepdims=True).clip(1e-20)
    b = jnp.cross(n, t)
    b = b / jnp.linalg.norm(b, axis=-1, keepdims=True).clip(1e-20)
    t = jnp.cross(b, n)
    t = t / jnp.linalg.norm(t, axis=-1, keepdims=True).clip(1e-20)

    dirs = jnp.asarray(directions, jnp.float32)
    n_dirs = dirs.shape[0]
    total = jnp.zeros((h, w), jnp.float32)
    for c0 in range(0, n_dirs, dir_chunk):
        d_loc = dirs[c0 : c0 + dir_chunk]  # (C, 3)
        d_loc = d_loc / jnp.linalg.norm(d_loc, axis=-1,
                                        keepdims=True).clip(1e-20)
        # local -> world per pixel: (h, w, C, 3)
        dw = (
            d_loc[None, None, :, 2:3] * n[..., None, :]
            + d_loc[None, None, :, 0:1] * t[..., None, :]
            + d_loc[None, None, :, 1:2] * b[..., None, :]
        )
        dw = dw / jnp.linalg.norm(dw, axis=-1, keepdims=True).clip(1e-20)
        ndl = jnp.maximum((dw * n[..., None, :]).sum(-1), 0.0)
        orig = jnp.broadcast_to(world_pos[..., None, :], dw.shape)
        hit = ray_any_hit(tri_grid, orig, dw, rt_radius,
                          max_steps=max_steps)
        total = total + (jnp.where(hit, 0.0, 1.0) * ndl).sum(-1)

    ao = 2.0 * total / n_dirs
    return jnp.where(depth_c >= 1.0, 0.0, ao)


@register("gtao_normal_space")
def gtao_normal_space(depth_half, normal_half, params: GTAOParams,
                      base_angle, dirs_count: int = 1):
    """main.comp gtao_normal_space (148-193): horizon march against the
    surface normal with cosine-free (1 - h^2) integration; larger radius
    clamp (200/|p|, 32px) and SAMPLES=20 steps."""
    h, w = depth_half.shape
    uv = screen_uv_grid(h, w)
    camera_pos = reconstruct_view_vec(
        uv, depth_half, params.fovy, params.aspect, params.znear,
        params.zfar,
    )
    nm = jnp.asarray(params.normal_mat)
    cam_n = apply_linear(decode_normal(normal_half), nm[:3, :3])
    cam_n = cam_n / jnp.linalg.norm(cam_n, axis=-1,
                                    keepdims=True).clip(1e-20)

    # tangent basis (main.comp get_tangent)
    max_xy = jnp.maximum(jnp.abs(cam_n[..., 0]), jnp.abs(cam_n[..., 1]))
    tangent = jnp.where(
        (max_xy < 1e-5)[..., None],
        jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0]), cam_n.shape),
        jnp.stack([cam_n[..., 1], -cam_n[..., 0],
                   jnp.zeros_like(max_xy)], -1),
    )
    tangent = tangent / jnp.linalg.norm(tangent, axis=-1,
                                        keepdims=True).clip(1e-20)
    bitangent = jnp.cross(cam_n, tangent)
    bitangent = bitangent / jnp.linalg.norm(
        bitangent, axis=-1, keepdims=True).clip(1e-20)
    tangent = jnp.cross(bitangent, cam_n)

    cls = gtao_direction_pattern(h, w).astype(jnp.float32) / 16.0
    size = jnp.asarray([w, h], jnp.float32)
    radius_px = jnp.minimum(
        200.0 / jnp.linalg.norm(camera_pos, axis=-1).clip(1e-20), 32.0
    )

    total = jnp.zeros((h, w), jnp.float32)
    for d in range(dirs_count):
        angle = 2.0 * PI * (cls + base_angle + d / dirs_count)
        sample_vec = (
            jnp.cos(angle)[..., None] * tangent
            + jnp.sin(angle)[..., None] * bitangent
        )
        from vkr.mathlib.projection import project_view_vec

        sdir = project_view_vec(
            camera_pos + sample_vec, params.fovy, params.aspect,
            params.znear, params.zfar,
        )[..., :2] - uv
        sdir = sdir / jnp.linalg.norm(sdir, axis=-1,
                                      keepdims=True).clip(1e-20)
        dir_uv = radius_px[..., None] * sdir / size

        def step(i, carry):
            h_cos, prev_z, alive = carry
            tc = uv + (i.astype(jnp.float32) / 20.0) * dir_uv
            sd = bilinear_sample(depth_half, tc)
            sp = reconstruct_view_vec(tc, sd, params.fovy, params.aspect,
                                      params.znear, params.zfar)
            alive = alive & ~(sp[..., 2] > prev_z + MAX_THICKNESS)
            prev_z = jnp.where(alive, sp[..., 2], prev_z)
            off = sp - camera_pos
            s_cos = (cam_n * off).sum(-1) / jnp.linalg.norm(
                off, axis=-1).clip(1e-20)
            h_cos = jnp.where(alive, jnp.maximum(h_cos, s_cos), h_cos)
            return h_cos, prev_z, alive

        h_cos, _, _ = jax.lax.fori_loop(
            1, 21, step,
            (jnp.full((h, w), -1.0), camera_pos[..., 2],
             jnp.ones((h, w), bool)),
        )
        h_cos = jnp.maximum(h_cos, 0.0)
        total = total + (1.0 - h_cos * h_cos)

    return jnp.where(depth_half >= 1.0, 1.0, total / dirs_count)


@register("gtao_main_mis")
def gtao_main_mis(depth_half, normal_half, material, pdf_lut,
                  ssr_occlusion, params: GTAOParams, base_angle,
                  weight_ratio: float = 1.0,
                  reflections_only: bool = False,
                  row0=None, band_h: "int | None" = None):
    """main.comp mis_gtao (219-274): MIS-combine one uniform-direction
    GTAO arc with the SSR trace's GGX-importance occlusion estimate
    (ssr_occlusion = SSR trace occlusion output (h, w, 2) = (sum, pdf),
    written into gtao.raw before this pass — main.cpp:375 ssr.run(...,
    gtao.raw)). This is the reference's DEFAULT main-pass mode
    (gtao.hpp:112 mis_gtao = true; weight_ratio default 1.0,
    gtao.hpp:116).

    The 16-step horizon march is the same find_horizon as
    gtao_camera_space (16 bilinear depth taps per pixel). material:
    FULL-res G-buffer material (roughness in .g, sampled at half-res
    pixel centers = exact 2x2 mean) or an already-half-res (h, w, C)
    array. row0/band_h (band mode): compute rows [row0, row0+band_h);
    depth_half / ssr_occlusion stay FULL."""
    from vkr.passes.ssr import sample_ggx_dir_pdf

    H, W = depth_half.shape
    uv, camera_pos, w0, cam_n, radius_px, depth_c = _common(
        depth_half, normal_half, params, row0=row0, band_h=band_h
    )
    h, w = depth_c.shape
    banded = row0 is not None
    cls = gtao_direction_pattern(h, w, row0=0 if row0 is None else row0
                                 ).astype(jnp.float32) / 16.0
    size = jnp.asarray([W, H], jnp.float32)
    angle = 2.0 * PI * (cls + base_angle)
    dir_uv = radius_px[..., None] * jnp.stack(
        [jnp.cos(angle), jnp.sin(angle)], -1) / size

    sample_end = reconstruct_view_vec(
        uv + dir_uv, depth_c, params.fovy, params.aspect, params.znear,
        params.zfar,
    )
    ldir = sample_end - camera_pos
    ldir = ldir / jnp.linalg.norm(ldir, axis=-1, keepdims=True).clip(1e-20)
    n_proj_len, n_angle = _arc_terms(
        uv, depth_c, camera_pos, w0, cam_n, dir_uv, params
    )

    def stp(i, carry):
        h_cos, prev_z, alive = carry
        tc = uv + (i.astype(jnp.float32) / N_STEPS) * dir_uv
        sd = bilinear_sample(depth_half, tc)
        sp = reconstruct_view_vec(tc, sd, params.fovy, params.aspect,
                                  params.znear, params.zfar)
        alive = alive & ~(sp[..., 2] > prev_z + MAX_THICKNESS)
        prev_z = jnp.where(alive, sp[..., 2], prev_z)
        off = sp - camera_pos
        s_cos = (w0 * off).sum(-1) / jnp.linalg.norm(
            off, axis=-1).clip(1e-20)
        h_cos = jnp.where(alive, jnp.maximum(h_cos, s_cos), h_cos)
        return h_cos, prev_z, alive

    h_cos, _, _ = jax.lax.fori_loop(
        1, N_STEPS + 1, stp,
        (jnp.full((h, w), -1.0), camera_pos[..., 2],
         jnp.ones((h, w), bool)),
    )
    occlusion = (1.0 / PI) * _arc_integral(h_cos, n_proj_len, n_angle)

    # roughness = texture(gbuffer_material, screen_uv).g — half-res pixel
    # centers land exactly between full-res texels, so bilinear = the
    # dense 2x2 mean (no gathers).
    if material.shape[:2] == (H, W):
        rough_half = material[..., 1]
    else:
        from vkr.passes.sampling import downsample_full_to_half

        rough_half = downsample_full_to_half(material[..., 1])
    if banded:
        rough_half = jax.lax.dynamic_slice(rough_half, (row0, 0), (h, w))
        ao = jax.lax.dynamic_slice(ssr_occlusion, (row0, 0, 0), (h, w, 2))
    else:
        ao = ssr_occlusion  # (h, w, 2): (sum, pdf)
    pdf_ggx = sample_ggx_dir_pdf(pdf_lut, w0, cam_n, ldir,
                                 rough_half * rough_half)
    pdf_uniform = 1.0 / (2.0 * PI)

    if reflections_only:
        res = ao[..., 0] / jnp.where(jnp.abs(ao[..., 1]) < 1e-20, 1e-20,
                                     ao[..., 1])
        res = jnp.where(jnp.isnan(res), 1.0, res)
        return jnp.where(depth_c >= 1.0, 0.0, res)

    alpha = 1.0 / (weight_ratio + 1.0)
    beta = 1.0 - alpha
    mw1 = alpha / (alpha * ao[..., 1] + beta * pdf_uniform)
    mw2 = beta / (alpha * pdf_ggx + beta * pdf_uniform)
    mis_ao = ao[..., 0] * mw1 + occlusion * mw2
    mis_ao = jnp.where(jnp.isnan(mis_ao), occlusion / pdf_uniform, mis_ao)
    return jnp.where(depth_c >= 1.0, 0.0, mis_ao)


@register("gtao_reproject")
def gtao_reproject(current_depth, prev_depth, current_ao, prev_ao,
                   camera_to_prev_frame, fovy, aspect, znear, zfar,
                   matrix_mode: bool = False, bias: float = 1e-6):
    """gtao/reproject.comp:27-68 — the standalone AO temporal-reproject
    variant (matrix-based; distinct from gtao_accumulate's
    velocity-based reprojection). Default is the shader's compiled-in
    STATIC_REPROJECT mode (reproject.comp:6): same-pixel depth match ->
    ao = mix(prev_ao, new_ao, 0.05). matrix_mode=True runs
    MATRIX_REPROJECT: reproject the view-space point through
    camera_to_prev_frame and bilinear-sample the previous frame (a
    registered non-default variant; uses the gather oracle path).
    bias: REPROJECT_BIAS (reproject.comp:8) — in matrix mode the
    1e-6 linearized-depth tolerance admits only bit-stable round trips,
    exactly as compiled into the shader."""
    coef = 0.05  # REPROJECT_COEF
    h, w = current_depth.shape
    new_ao = current_ao
    uv = screen_uv_grid(h, w)
    # reproject.comp:30 uses uv = pixel/size (no half-texel center)
    uv = uv - 0.5 / jnp.asarray([w, h], jnp.float32)
    cur_view = reconstruct_view_vec(uv, current_depth, fovy, aspect,
                                    znear, zfar)
    if matrix_mode:
        m = jnp.asarray(camera_to_prev_frame)
        rep = transform_points(cur_view, m, homogeneous=True)
        rep_w = rep[..., 3]
        prev_view = rep[..., :3] / jnp.where(jnp.abs(rep_w) < 1e-20, 1e-20,
                                             rep_w)[..., None]
        prev_xy = 0.5 * prev_view[..., :2] + 0.5
        in_bounds = (
            (prev_xy[..., 0] > 0) & (prev_xy[..., 0] < 1)
            & (prev_xy[..., 1] > 0) & (prev_xy[..., 1] < 1)
        )
        sampled_depth = bilinear_sample(prev_depth, prev_xy)
        sampled_ao = bilinear_sample(prev_ao, prev_xy)
        rep_z = linearize_depth(prev_view[..., 2], znear, zfar)
        sampled_z = linearize_depth(sampled_depth, znear, zfar)
        keep = (
            in_bounds
            & (jnp.abs(rep_z - sampled_z) < bias)
            & (sampled_depth < 1.0)
        )
    else:
        sampled_depth = prev_depth
        sampled_ao = prev_ao
        sampled_z = linearize_depth(sampled_depth, znear, zfar)
        keep = (
            (jnp.abs(sampled_z - cur_view[..., 2]) < bias)
            & (sampled_depth < 1.0)
        )
    blended = sampled_ao + coef * (new_ao - sampled_ao)  # mix(a, b, t)
    return jnp.where(keep, blended, new_ao)


@register("deinterleave_depth")
def deinterleave_depth(depth, pattern_step: int = 2):
    """gtao_opt/deinterleave.comp: (H, W) -> (layers, H>>n, W>>n) where
    layer = ((y & mask) << n) + (x & mask) — each layer is one phase of the
    2^n x 2^n dither lattice (the deinterleaved GTAO variant marches each
    layer coherently)."""
    n = pattern_step
    s = 1 << n
    h, w = depth.shape
    h2, w2 = h // s, w // s
    d = depth[: h2 * s, : w2 * s].reshape(h2, s, w2, s)
    # (h2, sy, w2, sx) -> layer (sy*s + sx) major
    return d.transpose(1, 3, 0, 2).reshape(s * s, h2, w2)


def interleave_layers(layers, pattern_step: int = 2):
    """Inverse of deinterleave_depth."""
    n = pattern_step
    s = 1 << n
    ll, h2, w2 = layers.shape
    d = layers.reshape(s, s, h2, w2).transpose(2, 0, 3, 1)
    return d.reshape(h2 * s, w2 * s)


@register("main_deinterleaved")
def gtao_main_deinterleaved(depth_half, normal_half, params: GTAOParams,
                            base_angle, pattern_step: int = 2):
    """gtao_opt/main_deinterleaved.comp analog: run the horizon march per
    dither layer (coherent directions within a layer) and re-interleave.
    Constructed-but-unwired in the reference's main loop (SURVEY.md §2.4);
    provided for component parity."""
    s = 1 << pattern_step
    h, w = depth_half.shape
    h2, w2 = h // s, w // s
    d_layers = deinterleave_depth(depth_half, pattern_step)
    n_layers = deinterleave_depth(normal_half[..., 0], pattern_step)
    n_layers2 = deinterleave_depth(normal_half[..., 1], pattern_step)

    outs = []
    for l in range(s * s):
        noct = jnp.stack([n_layers[l], n_layers2[l]], axis=-1)
        ao = gtao_main_exact(d_layers[l], noct, params,
                             base_angle + l / float(s * s))
        outs.append(ao)
    return interleave_layers(jnp.stack(outs), pattern_step)


@register("gtao_filter")
def gtao_filter(depth_half, raw_ao, znear: float, zfar: float,
                row0=None, band_h: "int | None" = None):
    """4x4 depth-bilateral average (filter.comp:32-50): offsets -2..+1,
    weight = max(0, 1 - 5|zs - z| / |z|).

    row0/band_h (band mode): compute only rows [row0, row0 + band_h);
    inputs stay FULL (2-row halo)."""
    H, W = depth_half.shape
    banded = row0 is not None
    h = band_h if banded else H
    w = W

    def halo(a):
        ap = jnp.pad(a, 2, mode="edge")
        if banded:
            ap = jax.lax.dynamic_slice(ap, (row0, 0), (h + 4, W + 4))
        return ap

    if banded:
        depth_c = jax.lax.dynamic_slice(depth_half, (row0, 0), (h, W))
    else:
        depth_c = depth_half
    z = linearize_depth(depth_c, znear, zfar)
    pad_d = halo(depth_half)
    pad_ao = halo(raw_ao)

    weight_sum = jnp.zeros((h, w), jnp.float32)
    ao = jnp.zeros((h, w), jnp.float32)
    for dx in range(-2, 2):
        for dy in range(-2, 2):
            zs = linearize_depth(
                pad_d[2 + dy : 2 + dy + h, 2 + dx : 2 + dx + w],
                znear, zfar,
            )
            wgt = jnp.maximum(
                0.0, 1.0 - 5.0 * jnp.abs(zs - z) / jnp.abs(z)
            )
            weight_sum = weight_sum + wgt
            ao = ao + wgt * pad_ao[2 + dy : 2 + dy + h,
                                   2 + dx : 2 + dx + w]
    return ao / jnp.maximum(weight_sum, 1e-20)


class GTAOAccumParams(NamedTuple):
    inverse_camera: jnp.ndarray       # (4,4)
    prev_inverse_camera: jnp.ndarray  # (4,4)
    mvp: jnp.ndarray                  # (4,4) current unjittered
    fovy: float
    aspect: float
    znear: float
    zfar: float


@register("gtao_accumulate")
def gtao_accumulate(depth_half, prev_depth_half, filtered_ao,
                    velocity_half, history, params: GTAOAccumParams,
                    clear_history, row0=None,
                    band_h: "int | None" = None):
    """Temporal accumulation (accum.comp): velocity reprojection validated
    by world-space reconstruction; running mean with sample count in .y.

    history: (h, w, 2) = (ao, samples/255). Returns same shape.

    row0/band_h (band mode): compute only rows [row0, row0 + band_h);
    inputs stay FULL (reprojection reads a velocity-radius window).
    """
    H, W = depth_half.shape
    banded = row0 is not None
    h = band_h if banded else H
    w = W
    uv = screen_uv_grid(h, w, row0=row0 if banded else 0, full_height=H)
    ts = jnp.asarray([W, H], jnp.float32)

    def band(a):
        if not banded:
            return a
        return jax.lax.dynamic_slice(
            a, (row0,) + (0,) * (a.ndim - 1), (h,) + a.shape[1:])

    depth_c = band(depth_half)
    velocity = band(velocity_half)
    prev_uv = uv + velocity
    in_bounds = (
        (prev_uv[..., 0] >= 0.0) & (prev_uv[..., 0] <= 1.0)
        & (prev_uv[..., 1] >= 0.0) & (prev_uv[..., 1] <= 1.0)
    )

    from vkr.passes.sampling import reproject_bilinear

    def world_pos(depth_tex, inv_cam, suv, vel):
        if vel is None:
            d = depth_tex
        else:
            d = reproject_bilinear(depth_tex, vel, row0=row0)
        v_cam = reconstruct_view_vec(
            suv, d, params.fovy, params.aspect, params.znear, params.zfar
        )
        return transform_points(v_cam, inv_cam)

    w_prev = world_pos(prev_depth_half, params.prev_inverse_camera,
                       prev_uv, velocity)
    mvp = jnp.asarray(params.mvp)
    prev_h = transform_points(w_prev, mvp, homogeneous=True)
    prev_ndc = prev_h[..., :3] / jnp.where(
        jnp.abs(prev_h[..., 3:4]) < 1e-20, 1e-20, prev_h[..., 3:4]
    )
    prev_world_uv = 0.5 * prev_ndc[..., :2] + 0.5
    delta = jnp.abs(prev_world_uv - uv) * ts

    cur_z = linearize_depth(depth_c, params.znear, params.zfar)
    prev_z = linearize_depth(prev_ndc[..., 2], params.znear, params.zfar)
    depth_err = jnp.abs(prev_z - cur_z)

    vel_delta = jnp.maximum(
        jnp.abs(velocity[..., 0]) * w, jnp.abs(velocity[..., 1]) * H
    )
    error = 0.1 * vel_delta + depth_err
    valid_samples = jnp.clip(1.0 - error, 0.8, 1.0)
    reprojected = (
        in_bounds
        & (jnp.maximum(delta[..., 0], delta[..., 1]) <= 2.0)
        & (depth_err < 0.2)
        & ~clear_history
    )

    accumulated = reproject_bilinear(history, velocity, row0=row0)
    samples = 255.0 * accumulated[..., 1] * valid_samples
    new_ao = band(filtered_ao)
    acc_ao = (accumulated[..., 0] * samples + new_ao) / (samples + 1.0)
    samples_next = samples + 1.0
    samples_next = jnp.where(samples_next > 255.0, 100.0, samples_next)

    out_ao = jnp.where(reprojected, acc_ao, new_ao)
    out_samples = jnp.where(reprojected, samples_next, 1.0)
    return jnp.stack(
        [jnp.clip(out_ao, 0.0, 1.0), out_samples / 255.0], axis=-1
    )
