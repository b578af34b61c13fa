"""Stochastic hi-Z screen-space reflections (SSSR), half resolution.

Reference: src/advanced_ssr.cpp + shaders/advanced_ssr/{trace,filter,blur,
preintegrate,preintegrate_ssr}.comp. Chain (advanced_ssr.cpp run()):
  trace  — GGX VNDF importance sample (halton-indexed), reflect, then the
           FFX-style hierarchical hi-Z DDA march over the depth mip pyramid
           with an AO-style occlusion estimate tracked on fine mips
  filter — cross-shaped 5-tap resolve weighting neighbor rays by this
           pixel's BRDF (F * G2/G1), depth-bilateral
  blur   — roughness-adaptive gaussian with depth/normal bilateral weights
           + velocity-validated history reprojection (0.1 blend)

The march's per-pixel dynamic mip fetches use a FLAT-packed depth pyramid
(one gather per iteration); the march itself is in passes/ssr_march.py.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from vkr.mathlib.transforms import apply_linear, transform_points
from vkr.mathlib.brdf import (
    brdf_g1,
    brdf_g2,
    f0_approximation,
    fresnel_schlick,
    halton23_table,
    sample_ggx_vndf,
)
from vkr.mathlib.octahedral import decode_normal
from vkr.mathlib.projection import (
    linearize_depth,
    project_view_vec,
    reconstruct_view_vec,
)
from vkr.passes.sampling import screen_uv_grid
from vkr.passes.ssr_march import march_kernel, march_plain

from vkr.core.registry import register

PI = math.pi
HALTON_SEQ_SIZE = 128  # advanced_ssr.cpp:6


class SSRParams(NamedTuple):
    normal_mat: jnp.ndarray
    fovy: float
    aspect: float
    znear: float
    zfar: float
    max_roughness: float = 1.0


# ---------------------------------------------------------------- LUTs

@register("pdf_preintegrate")
def preintegrate_pdf(size: int = 1024, steps: int = 2000):
    """GGX direction-PDF LUT (preintegrate.comp, G2 variant): integrate
    (1-t)L / (1 + t^2 - L^2/2)^2, L = (b-a)t + (b+a), t in [-1, 1]."""
    px = (jnp.arange(size, dtype=jnp.float32) + 0.5) / size
    a = (2.0 * px - 1.0)[None, :]
    b = px[:, None]
    p = b - a
    q = b + a

    def body(i, acc):
        t = -1.0 + 2.0 / steps * (i.astype(jnp.float32) + 0.5)
        big_l = p * t + q
        nom = (1.0 - t) * big_l
        den = 1.0 + t * t - 0.5 * big_l * big_l
        g = jnp.where(big_l > 0.0, nom / (den * den), 0.0)
        return acc + g

    acc = jax.lax.fori_loop(
        0, steps, body, jnp.zeros((size, size), jnp.float32)
    )
    return 2.0 / steps * acc


@register("brdf_preintegrate")
def preintegrate_brdf(size: int = 1024, num_samples: int = 128):
    """Split-sum environment BRDF LUT (preintegrate_ssr.comp): x =
    roughness, y = NdotV -> (A, B) with reflection = F0*A + B."""
    px = (jnp.arange(size, dtype=jnp.float32) + 0.5) / size
    roughness = px[None, :]
    ndv = px[:, None]
    r2 = roughness * roughness
    v = jnp.stack(
        [jnp.sqrt(jnp.maximum(1.0 - ndv * ndv, 0.0))
         * jnp.ones_like(roughness),
         jnp.zeros((size, size), jnp.float32),
         ndv * jnp.ones_like(roughness)], axis=-1,
    )
    samples = jnp.asarray(halton23_table(num_samples))

    def body(i, acc):
        a_sum, b_sum = acc
        u = samples[i]
        h = sample_ggx_vndf(v, r2, r2, u[0], u[1])
        # reflect(-V, H) = -V + 2*dot(V,H)*H  (GLSL reflect(I,N)=I-2dot(I,N)N)
        vdh = (v * h).sum(-1)
        l = -v + 2.0 * vdh[..., None] * h
        l = l / jnp.linalg.norm(l, axis=-1, keepdims=True).clip(1e-20)
        ndl = l[..., 2]
        alpha = (1.0 - vdh) ** 5
        g1 = brdf_g1(r2, ndv * jnp.ones_like(roughness))
        g2 = brdf_g2(ndv * jnp.ones_like(roughness), ndl, r2)
        ratio = g2 / jnp.maximum(g1, 1e-20)
        return a_sum + ratio * (1.0 - alpha), b_sum + ratio * alpha

    zeros = jnp.zeros((size, size), jnp.float32)
    a_sum, b_sum = jax.lax.fori_loop(0, num_samples, body, (zeros, zeros))
    return jnp.stack([a_sum / num_samples, b_sum / num_samples], axis=-1)


def sample_ggx_dir_pdf(pdf_lut, w0, n, l, alpha):
    """sampleGGXdirPDF (brdf.glsl:104-127): LUT lookup form of the VNDF
    direction pdf."""
    y = jnp.cross(w0, n)
    y = y / jnp.linalg.norm(y, axis=-1, keepdims=True).clip(1e-20)
    x = jnp.cross(y, w0)
    x = x / jnp.linalg.norm(x, axis=-1, keepdims=True).clip(1e-20)
    alpha = jnp.clip(alpha, 0.0, 0.9)

    l_proj = l - w0 * (w0 * l).sum(-1, keepdims=True)
    l_proj = l_proj / jnp.linalg.norm(l_proj, axis=-1,
                                      keepdims=True).clip(1e-20)
    cos_theta = (x * l_proj).sum(-1)
    cos_phin = (n * x).sum(-1)
    sin_phin = jnp.sqrt(jnp.maximum(1.0 - cos_phin * cos_phin, 0.0))

    alpha2 = alpha * alpha
    coef = jnp.sqrt(jnp.maximum(1.0 - alpha2, 1e-20))
    a = 0.5 * coef * cos_phin * cos_theta + 0.5
    b = coef * sin_phin
    from vkr.passes.sampling import bilinear_from_quad, quad_pack

    lut = bilinear_from_quad(quad_pack(pdf_lut), 1,
                             jnp.stack([a, b], axis=-1))[..., 0]
    return alpha2 / (2.0 * PI * coef) * lut


# ------------------------------------------------------- flat pyramid

class FlatPyramid(NamedTuple):
    """Depth mip pyramid packed into one flat array for single-gather
    per-pixel dynamic-mip fetches."""

    flat: jnp.ndarray          # (sum h_l*w_l,) f32
    offsets: Tuple[int, ...]   # static per-level start
    heights: Tuple[int, ...]
    widths: Tuple[int, ...]


def pack_pyramid(mips) -> FlatPyramid:
    offsets = []
    off = 0
    for m in mips:
        offsets.append(off)
        off += m.shape[0] * m.shape[1]
    flat = jnp.concatenate([m.reshape(-1) for m in mips])
    return FlatPyramid(
        flat=flat,
        offsets=tuple(offsets),
        heights=tuple(int(m.shape[0]) for m in mips),
        widths=tuple(int(m.shape[1]) for m in mips),
    )


# ------------------------------------------------------------- trace

def _get_tangent(n):
    """main.comp get_tangent."""
    max_xy = jnp.maximum(jnp.abs(n[..., 0]), jnp.abs(n[..., 1]))
    t = jnp.where(
        (max_xy < 1e-5)[..., None],
        jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0]), n.shape),
        jnp.stack([n[..., 1], -n[..., 0], jnp.zeros_like(max_xy)], -1),
    )
    return t / jnp.linalg.norm(t, axis=-1, keepdims=True).clip(1e-20)


@functools.lru_cache(maxsize=8)
def _halton_base_table(height: int, width: int):
    """Per-pixel halton base index of the (height, width) trace grid:
    trace.comp rand(uv) = fract(sin(dot(uv, (12.9898, 78.233))) *
    43758.5453), scaled to HALTON_SEQ_SIZE, as a (height, width) uint8
    table made once on the host.

    The hash amplifies one ulp of its argument ~4e4-fold. Evaluated in
    the frame, it would draw another sample wherever a program contracts
    the dot product into an FMA and another does not, so the band of a
    multi-device frame and the full frame would trace different rays.
    The table is the same constant in every program."""
    import numpy as np

    u = (np.arange(width, dtype=np.float32) + np.float32(0.5)) \
        / np.float32(width)
    v = (np.arange(height, dtype=np.float32) + np.float32(0.5)) \
        / np.float32(height)
    dot = u[None, :] * np.float32(12.9898) + v[:, None] * np.float32(78.233)
    s = np.sin(dot.astype(np.float64)) * 43758.5453
    rand = (s - np.floor(s)).astype(np.float32)
    return np.minimum(rand * HALTON_SEQ_SIZE,
                      HALTON_SEQ_SIZE - 1).astype(np.uint8)


def halton_base_index(height: int, width: int, row0=None,
                      band_h: "int | None" = None):
    """Rows [row0, row0 + band_h) of _halton_base_table (all rows when
    row0 is None; row0 may be traced) as uint32."""
    table = jnp.asarray(_halton_base_table(height, width))
    if row0 is not None:
        table = jax.lax.dynamic_slice(table, (row0, 0), (band_h, width))
    return table.astype(jnp.uint32)


def _reflection_ray_setup(uv, base_index, pixel_depth, normal_band,
                          roughness, params, frame_random, halton):
    """Shared per-pixel reflection ray construction (trace.comp:47-93 ==
    trace_indirect.comp:58-93): GGX-VNDF microfacet normal from the
    halton pair, R = reflect(view_vec, N), projective ray start/dir.
    base_index: the pixels' halton_base_index. Returns (view_vec, w0,
    camera normal n, reflection dir r, ray_start, ray_dir)."""
    n_world = decode_normal(normal_band)
    nm = jnp.asarray(params.normal_mat)
    n = apply_linear(n_world, nm[:3, :3])
    n = n / jnp.linalg.norm(n, axis=-1, keepdims=True).clip(1e-20)
    view_vec = reconstruct_view_vec(
        uv, pixel_depth, params.fovy, params.aspect, params.znear,
        params.zfar,
    )

    index = (base_index + frame_random.astype(jnp.uint32)) & (
        HALTON_SEQ_SIZE - 1
    )
    rnd = jnp.asarray(halton)[index]

    tangent = _get_tangent(n)
    bitangent = jnp.cross(n, tangent)
    bitangent = bitangent / jnp.linalg.norm(
        bitangent, axis=-1, keepdims=True).clip(1e-20)
    tangent = jnp.cross(bitangent, n)
    tangent = tangent / jnp.linalg.norm(
        tangent, axis=-1, keepdims=True).clip(1e-20)

    w0 = -view_vec / jnp.linalg.norm(view_vec, axis=-1,
                                     keepdims=True).clip(1e-20)
    vd = jnp.stack(
        [(w0 * tangent).sum(-1), (w0 * bitangent).sum(-1),
         (w0 * n).sum(-1)], -1,
    )
    brdf_n = sample_ggx_vndf(vd, roughness, roughness,
                             rnd[..., 0], rnd[..., 1])
    big_n = (
        brdf_n[..., 0:1] * tangent
        + brdf_n[..., 1:2] * bitangent
        + brdf_n[..., 2:3] * n
    )
    # R = reflect(view_vec, N)
    r = view_vec - 2.0 * (view_vec * big_n).sum(-1, keepdims=True) * big_n

    ray_start = project_view_vec(
        view_vec + 0.001 * n, params.fovy, params.aspect, params.znear,
        params.zfar,
    )
    ray_start = ray_start.at[..., 2].add(-0.0001)
    ray_dir = project_view_vec(
        view_vec + r, params.fovy, params.aspect, params.znear, params.zfar
    ) - ray_start
    scale = (1.0 - ray_start[..., 2]) / jnp.where(
        jnp.abs(ray_dir[..., 2]) < 1e-20, 1e-20, ray_dir[..., 2]
    )
    ray_dir = ray_dir * scale[..., None]
    return view_vec, w0, n, r, ray_start, ray_dir


def trace_rays(hiz: FlatPyramid, normal_half, material_full,
               params: SSRParams, frame_random, halton, row0=None,
               band_h: "int | None" = None):
    """The SSR trace's per-pixel reflection rays (trace.comp:47-93), the
    march's inputs: dict of pixel_depth, roughness (alpha), view_vec,
    w0, n, r, ray_start, ray_dir. row0/band_h as in ssr_trace."""
    h, w = hiz.heights[0], hiz.widths[0]
    banded = row0 is not None
    bh = band_h if banded else h
    uv = screen_uv_grid(bh, w, row0=row0 if banded else 0, full_height=h)

    from vkr.passes.sampling import downsample_full_to_half

    depth_full = hiz.flat[: h * w].reshape(h, w)
    if banded:
        mat_in = jax.lax.dynamic_slice(
            material_full, (2 * row0, 0, 0),
            (2 * bh, material_full.shape[1], material_full.shape[2]))
        normal_band = jax.lax.dynamic_slice(
            normal_half, (row0, 0, 0), (bh, w, normal_half.shape[2]))
        pixel_depth = jax.lax.dynamic_slice(depth_full, (row0, 0),
                                            (bh, w))
    else:
        mat_in = material_full
        normal_band = normal_half
        pixel_depth = depth_full
    material = downsample_full_to_half(mat_in)[:bh, :w]
    biased = params.max_roughness * material[..., 1]
    roughness = biased * biased  # alpha

    base_index = halton_base_index(h, w, row0 if banded else None, bh)
    view_vec, w0, n, r, ray_start, ray_dir = _reflection_ray_setup(
        uv, base_index, pixel_depth, normal_band, roughness, params,
        frame_random, halton,
    )
    return dict(pixel_depth=pixel_depth, roughness=roughness,
                view_vec=view_vec, w0=w0, n=n, r=r, ray_start=ray_start,
                ray_dir=ray_dir)


@register("sssr_trace")
def ssr_trace(
    hiz: FlatPyramid,
    normal_half,
    material_full,
    pdf_lut,
    params: SSRParams,
    frame_random,
    halton,
    max_iterations: int = 80,
    use_pallas: bool = False,
    interpret: bool = False,
    row0=None,
    band_h: "int | None" = None,
):
    """trace.comp main(): returns (ray_info (h, w, 4) = hit uvz + src depth
    [1.0 = invalid], occlusion (h, w, 2) = AO estimate + pdf).

    use_pallas: march with the GPU kernel (ssr_march.march_kernel;
    interpret=True runs it in the Pallas interpreter) instead of the
    plain XLA march. Both march every ray to the iteration cap.
    row0/band_h (band mode, parallel/band.py): compute only trace rows
    [row0, row0 + band_h) — inputs stay FULL-frame (the march fetches
    globally); row0 may be traced."""
    h, w = hiz.heights[0], hiz.widths[0]
    size = jnp.asarray([w, h], jnp.float32)
    rays = trace_rays(hiz, normal_half, material_full, params,
                      frame_random, halton, row0=row0, band_h=band_h)
    view_vec, w0, n, r = rays["view_vec"], rays["w0"], rays["n"], rays["r"]
    ray_start, ray_dir = rays["ray_start"], rays["ray_dir"]
    pixel_depth, roughness = rays["pixel_depth"], rays["roughness"]
    nm = jnp.asarray(params.normal_mat)

    march = (functools.partial(march_kernel, interpret=interpret)
             if use_pallas else march_plain)
    position, hor, iters = march(hiz, ray_start, ray_dir, view_vec, w0,
                                 params, max_iterations)
    valid_hit = iters <= max_iterations

    # Post-march validation (trace.comp:97-122)
    ray_step = jnp.abs(position[..., :2] - ray_start[..., :2]) * size
    valid_hit = valid_hit & (
        jnp.maximum(ray_step[..., 0], ray_step[..., 1]) >= 2.0
    )

    from vkr.passes.sampling import bilinear_from_quad, quad_pack

    hit_n_world = decode_normal(
        bilinear_from_quad(quad_pack(normal_half), 2, position[..., :2])
    )
    hit_n = apply_linear(hit_n_world, nm[:3, :3])
    valid_hit = valid_hit & ~(
        ((hit_n * r).sum(-1) > 0) | ((n * r).sum(-1) < 0)
    )

    # textureLod(DEPTH, xy, 0) = bilinear on the half-res base mip
    hit_depth = bilinear_from_quad(
        quad_pack(hiz.flat[: h * w].reshape(h, w)), 1, position[..., :2]
    )[..., 0]
    hit_z = linearize_depth(hit_depth, params.znear, params.zfar)
    ray_z = linearize_depth(position[..., 2], params.znear, params.zfar)
    valid_hit = valid_hit & ~(
        (ray_z > hit_z + 0.3) | (ray_z < hit_z - 0.1)
    )

    ray_info = jnp.concatenate(
        [position, jnp.where(valid_hit, pixel_depth, 1.0)[..., None]], -1
    )

    # occlusion estimate (trace.comp:126-146)
    slice_n = jnp.cross(w0, r)
    slice_n = slice_n / jnp.linalg.norm(slice_n, axis=-1,
                                        keepdims=True).clip(1e-20)
    n_proj = n - (n * slice_n).sum(-1, keepdims=True) * slice_n
    n_len = jnp.linalg.norm(n_proj, axis=-1).clip(1e-20)
    x_axis = jnp.cross(slice_n, w0)
    x_axis = x_axis / jnp.linalg.norm(x_axis, axis=-1,
                                      keepdims=True).clip(1e-20)
    n_ang = PI / 2.0 - jnp.arccos(
        jnp.clip(((n_proj / n_len[..., None]) * x_axis).sum(-1), -1, 1)
    )
    no_occlusion = hor == -1.0
    hh = jnp.arccos(jnp.clip(hor, -1.0, 1.0))
    hh = jnp.minimum(n_ang + jnp.minimum(hh - n_ang, PI / 2.0), hh)
    pdf = sample_ggx_dir_pdf(pdf_lut, w0, n, r, roughness)
    occl = (1.0 / PI) * n_len * 0.25 * jnp.maximum(
        -jnp.cos(2 * hh - n_ang) + jnp.cos(n_ang)
        + 2 * hh * jnp.sin(n_ang), 0.0,
    )
    occl = jnp.where(jnp.isnan(occl), 0.0, occl)
    occlusion = jnp.stack(
        [jnp.where(no_occlusion, 0.0, occl),
         jnp.where(no_occlusion, 0.0, pdf)], -1,
    )
    return ray_info, occlusion


# ------------------------------------------------------------- filter

def _ray_weight(n, v, l, f0, roughness):
    """filter.comp ray_weight: F * G2 / G1 (note the reference passes
    (NdotL, NdotV) into brdfG2's (NdotV, NdotL) slots — kept)."""
    hv = v + l
    hv = hv / jnp.linalg.norm(hv, axis=-1, keepdims=True).clip(1e-20)
    f = fresnel_schlick(jnp.maximum((hv * v).sum(-1), 0.0)[..., None], f0)
    alpha2 = roughness * roughness
    ndl = jnp.maximum((n * l).sum(-1), 0.0)
    ndv = jnp.maximum((n * v).sum(-1), 0.0)
    g2 = brdf_g2(ndl, ndv, alpha2)
    g1 = brdf_g1(alpha2, ndv)
    return f * (g2 / jnp.maximum(g1, 1e-20))[..., None]


@register("sssr_filter")
def ssr_filter(
    rays,            # (h, w, 4) trace output
    depth_half,      # depth mip 1
    albedo_full,     # (H, W, 3+) linear albedo (radiance source)
    normal_half,     # (h, w, 2)
    material_full,
    params: SSRParams,
    flags_normalize: bool = True,
    flags_bilateral: bool = True,
    row0=None,
    band_h: "int | None" = None,
):
    """filter.comp: 5-tap cross resolve, BRDF-weighted.

    row0/band_h (band mode): compute only rows [row0, row0 + band_h);
    inputs stay FULL-frame (the hit-uv radiance gather is global; the
    5-tap cross takes a 1-row halo)."""
    H, W = depth_half.shape
    banded = row0 is not None
    h = band_h if banded else H
    w = W
    # NOTE: filter.comp uses uv = pixel/tex_size (no half-texel!)
    xs = jnp.arange(w, dtype=jnp.float32) / w
    ys = ((row0 if banded else 0)
          + jnp.arange(h, dtype=jnp.float32)) / H
    uv = jnp.stack(jnp.meshgrid(xs, ys), axis=-1)

    from vkr.passes.sampling import downsample_full_to_half_corner

    def band(a):
        if not banded:
            return a
        return jax.lax.dynamic_slice(
            a, (row0,) + (0,) * (a.ndim - 1), (h,) + a.shape[1:])

    material = band(downsample_full_to_half_corner(material_full)
                    [:H, :W])
    metallic = material[..., 2]
    roughness = material[..., 1]
    albedo = band(downsample_full_to_half_corner(albedo_full[..., :3])
                  [:H, :W])
    f0 = f0_approximation(albedo, metallic)
    nm = jnp.asarray(params.normal_mat)

    center_depth = band(depth_half)

    from vkr.passes.sampling import bilinear_from_quad, quad_pack

    albedo_quad = quad_pack(albedo_full[..., :3])

    pad = 1

    def halo_rows(a):
        # rows [row0 - pad, row0 + h + pad) with frame-edge replication
        ap = jnp.pad(a, ((pad, pad),) + ((0, 0),) * (a.ndim - 1),
                     mode="edge")
        if banded:
            ap = jax.lax.dynamic_slice(
                ap, (row0,) + (0,) * (a.ndim - 1),
                (h + 2 * pad,) + a.shape[1:])
        return ap

    rays_h = halo_rows(rays)
    # Each tap samples radiance at the NEIGHBOR ray's hit uv — exactly the
    # value the center tap computes at that neighbor pixel. Gather once per
    # pixel (on the halo-extended rows) and shift (5 gathers -> 1).
    radiance_h = jnp.where(
        (rays_h[..., 3] != 1.0)[..., None],
        bilinear_from_quad(albedo_quad, 3, rays_h[..., :2]),
        0.0,
    )
    rays_p = jnp.pad(rays_h, ((0, 0), (pad, pad), (0, 0)), mode="edge")
    rad_p = jnp.pad(radiance_h, ((0, 0), (pad, pad), (0, 0)),
                    mode="edge")
    depth_p = jnp.pad(halo_rows(depth_half), ((0, 0), (pad, pad)),
                      mode="edge")
    normal_p = jnp.pad(halo_rows(normal_half),
                       ((0, 0), (pad, pad), (0, 0)), mode="edge")

    color_sum = jnp.zeros((h, w, 3), jnp.float32)
    weight_sum = jnp.zeros((h, w, 3), jnp.float32)

    offsets = ([(0, 0), (-1, 0), (0, 1), (1, 0), (0, -1)]
               if flags_normalize else [(0, 0)])
    for dx, dy in offsets:
        tr = rays_p[pad + dy : pad + dy + h, pad + dx : pad + dx + w]
        p_depth = depth_p[pad + dy : pad + dy + h, pad + dx : pad + dx + w]
        p_uv = uv + jnp.asarray([dx / w, dy / H], jnp.float32)
        p_oct = normal_p[pad + dy : pad + dy + h, pad + dx : pad + dx + w]

        view_vec = reconstruct_view_vec(
            p_uv, p_depth, params.fovy, params.aspect, params.znear,
            params.zfar,
        )
        p_normal = apply_linear(decode_normal(p_oct), nm[:3, :3])

        hit_vec = reconstruct_view_vec(
            tr[..., :2], tr[..., 2], params.fovy, params.aspect,
            params.znear, params.zfar,
        )
        radiance = rad_p[pad + dy : pad + dy + h, pad + dx : pad + dx + w]
        v = -view_vec / jnp.linalg.norm(view_vec, axis=-1,
                                        keepdims=True).clip(1e-20)
        l = hit_vec - view_vec
        l = l / jnp.linalg.norm(l, axis=-1, keepdims=True).clip(1e-20)
        weight = _ray_weight(p_normal, v, l, f0, roughness)
        if flags_bilateral:
            bw = jnp.maximum(
                1.0 - 1000.0 * jnp.abs(center_depth - p_depth)
                / jnp.abs(center_depth).clip(1e-20), 0.0,
            )
            weight = weight * bw[..., None]
        color_sum = color_sum + weight * radiance
        weight_sum = weight_sum + weight

    wmax = weight_sum.max(axis=-1, keepdims=True)
    weight_sum = jnp.where(wmax < 0.001, 1.0, weight_sum)
    return color_sum / weight_sum


# --------------------------------------------------------------- blur

class SSRBlurParams(NamedTuple):
    inverse_camera: jnp.ndarray
    prev_inverse_camera: jnp.ndarray
    fovy: float
    aspect: float
    znear: float
    zfar: float
    max_roughness: float = 1.0
    accumulate: bool = True
    disable_blur: bool = False


MAX_BLUR_RADIUS = 11  # sigma <= 4 -> r = floor(12 - eps)


@register("sssr_blur")
def ssr_blur(
    reflections,      # (h, w, 3) filtered
    depth_half,
    normal_half,
    material_full,
    history,          # (h, w, 3)
    velocity_half,    # (h, w, 2)
    prev_depth_half,
    params: SSRBlurParams,
    row0=None,
    band_h: "int | None" = None,
):
    """blur.comp: per-pixel roughness-adaptive gaussian (sigma in
    [0.4, 4]) with depth/normal bilateral weights, then velocity-validated
    history blend (0.1).

    row0/band_h (band mode): compute only rows [row0, row0 + band_h);
    inputs stay FULL-frame (the gaussian takes a MAX_BLUR_RADIUS halo,
    history reprojection a velocity-radius window)."""
    H, W = depth_half.shape
    banded = row0 is not None
    h = band_h if banded else H
    w = W
    uv = screen_uv_grid(h, w, row0=row0 if banded else 0, full_height=H)

    def band(a):
        if not banded:
            return a
        return jax.lax.dynamic_slice(
            a, (row0,) + (0,) * (a.ndim - 1), (h,) + a.shape[1:])

    from vkr.passes.sampling import downsample_full_to_half

    roughness = band(
        downsample_full_to_half(material_full[..., 1])[:H, :W])
    roughness = params.max_roughness * roughness
    sigma = 0.4 + (4.0 - 0.4) * roughness
    if params.disable_blur:
        sigma = jnp.full_like(sigma, 0.35)
    r_pix = jnp.floor(3.0 * sigma - 0.01)

    center_normal = decode_normal(band(normal_half))
    # blur.comp's gaussian prefactor 1/(2 pi sigma^2) multiplies every
    # tap equally and cancels in color/weight_sum — not computed.
    e = 2.0 * sigma * sigma

    pad = MAX_BLUR_RADIUS

    def halo_rows(a):
        ap = jnp.pad(a, ((pad, pad),) + ((0, 0),) * (a.ndim - 1),
                     mode="edge")
        if banded:
            ap = jax.lax.dynamic_slice(
                ap, (row0,) + (0,) * (a.ndim - 1),
                (h + 2 * pad,) + a.shape[1:])
        return ap

    refl_p = jnp.pad(halo_rows(reflections),
                     ((0, 0), (pad, pad), (0, 0)), mode="edge")
    depth_p = jnp.pad(halo_rows(depth_half), ((0, 0), (pad, pad)),
                      mode="edge")
    # decode the octahedral normals ONCE on the padded array instead of
    # per tap (529 taps x ~8 decode ops on the full image)
    normal_p = decode_normal(jnp.pad(
        halo_rows(normal_half), ((0, 0), (pad, pad), (0, 0)),
        mode="edge"))
    depth_c = band(depth_half)

    side = 2 * MAX_BLUR_RADIUS + 1

    def tap(k, carry):
        color, weight_sum = carry
        i = k % side - MAX_BLUR_RADIUS
        j = k // side - MAX_BLUR_RADIUS
        fi = i.astype(jnp.float32)
        fj = j.astype(jnp.float32)
        in_r = (jnp.abs(fi) <= r_pix) & (jnp.abs(fj) <= r_pix)
        p_depth = jax.lax.dynamic_slice(depth_p, (pad + j, pad + i),
                                        (h, w))
        p_norm = jax.lax.dynamic_slice(normal_p, (pad + j, pad + i, 0),
                                       (h, w, 3))
        bw = jnp.maximum(
            1.0 - 1000.0 * jnp.abs(depth_c - p_depth)
            / jnp.abs(depth_c).clip(1e-20), 0.0,
        )
        nw = jnp.maximum((center_normal * p_norm).sum(-1), 0.0)
        wgt = jnp.exp(-(fi * fi + fj * fj) / e) * bw * nw
        wgt = jnp.where(in_r, wgt, 0.0)
        color = color + (
            jax.lax.dynamic_slice(refl_p, (pad + j, pad + i, 0),
                                  (h, w, 3)) * wgt[..., None]
        )
        return color, weight_sum + wgt

    color, weight_sum = jax.lax.fori_loop(
        0, side * side, tap,
        (jnp.zeros((h, w, 3), jnp.float32), jnp.zeros((h, w), jnp.float32)),
    )
    # the dropped gaussian prefactor g = 1/(2 pi sigma^2) rescales the
    # blur.comp weight floor: max(g*ws, 0.001) == g * max(ws, 0.001/g)
    floor = 0.001 * (2.0 * math.pi) * sigma * sigma
    color = color / jnp.maximum(weight_sum, floor)[..., None]

    # history reprojection (blur.comp:82-106)
    velocity = band(velocity_half)
    prev_uv = uv + velocity
    in_b = (
        (prev_uv[..., 0] >= 0) & (prev_uv[..., 0] <= 1)
        & (prev_uv[..., 1] >= 0) & (prev_uv[..., 1] <= 1)
    )

    from vkr.passes.sampling import reproject_bilinear

    def world(dtex, inv_cam, suv, vel=None):
        if vel is None:
            d = dtex
        else:
            d = reproject_bilinear(dtex, vel, row0=row0)
        vc = reconstruct_view_vec(suv, d, params.fovy, params.aspect,
                                  params.znear, params.zfar)
        return transform_points(vc, inv_cam)

    w_cur = world(depth_c, params.inverse_camera, uv)
    w_prev = world(prev_depth_half, params.prev_inverse_camera, prev_uv,
                   vel=velocity)
    cam = jnp.asarray(params.inverse_camera)[:3, 3]
    err = jnp.linalg.norm(w_cur - w_prev, axis=-1)
    pixel_dist = jnp.linalg.norm(w_cur - cam[None, None, :], axis=-1)
    vlen = jnp.linalg.norm(velocity, axis=-1)
    reprojected = in_b & (
        (vlen < 1e-4)
        | (err < jnp.clip(0.1 * pixel_dist * vlen, 0.01, 0.1))
    )
    if not params.accumulate:
        reprojected = jnp.zeros_like(reprojected)

    # NOTE: blur.comp samples HISTORY_TEX at screen_uv (not prev_uv)
    hist = band(history)
    out = jnp.where(
        reprojected[..., None], hist + (color - hist) * 0.1, color
    )
    return out
