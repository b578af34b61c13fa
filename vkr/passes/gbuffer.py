"""G-buffer raster pass.

The analog of SceneRenderer::draw_taa (scene_renderer.cpp:140-215) +
gbuf/opaque_taa.{vert,frag}: renders the scene into
  albedo   (H, W, 4)  linear color (RGBA8_SRGB storage emulated)
  normal   (H, W, 2)  octahedral encoding in [0,1] (RG16_UNORM emulated)
  material (H, W, 4)  metallic-roughness texel (g=roughness, b=metallic)
  velocity (H, W, 2)  0.5 * (prev_ndc - cur_ndc) (RG16F emulated)
  depth    (H, W)     hardware depth (D24 emulated), 1.0 clear

Alpha-MASK materials (opaque_taa.frag:32-34 discards alpha == 0) run as a
second raster phase over the masked triangle subset whose coverage is
alpha-tested at resolve, then depth-merged with the opaque phase — the
visibility-buffer equivalent of fragment discard (one transparency layer
deep; the reference's per-fragment discard handles arbitrary depth).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from vkr.core.formats import (
    linear_to_srgb,
    quantize_d24,
    quantize_f16,
    quantize_unorm,
    srgb_to_linear,
)
from vkr.mathlib.octahedral import encode_normal
from vkr.raster import rasterize, transform_normals, transform_vertices
from vkr.raster.texture import (
    TextureArray,
    pack_texture_array,
    pack_texture_array_native,
    quad_derivative_lod,
    quad_derivative_lod_native,
    sample_alpha_sparse,
    sample_material_pair,
    sample_texture_array,
    small_lookup,
)
from vkr.scene.scene import CompiledScene

from vkr.core.registry import register


class SceneDevice(NamedTuple):
    """Device-resident scene (upload_scene). Triangles are pre-split into
    opaque / alpha-MASK subsets (static shapes)."""

    positions: jnp.ndarray
    normals: jnp.ndarray
    uvs: jnp.ndarray
    vert_transform: jnp.ndarray
    transforms: jnp.ndarray
    normal_mats: jnp.ndarray
    tri_opaque: jnp.ndarray       # (T1, 3)
    tri_opaque_mat: jnp.ndarray   # (T1,)
    tri_masked: jnp.ndarray       # (T2, 3)
    tri_masked_mat: jnp.ndarray   # (T2,)
    mat_albedo_tex: jnp.ndarray
    mat_mr_tex: jnp.ndarray
    tex: TextureArray
    # Static pre-expansion: per-corner world-space tables built ONCE at
    # upload. Every per-frame index in the raster front end is static
    # (vertex indices, node transforms), so the gathers (clip[indices],
    # vattrs[indices], transforms[ids]) are paid once here instead of
    # every frame. The SoA front-end math downstream
    # of the corner transform is BITWISE identical to the row-major path
    # (tests/test_raster.py::TestSoAFrontEnd); the corner transform
    # itself rounds ~1 ulp differently from the generic in-graph
    # world->clip fusion (isolated knife-edge coverage flips only).
    # None = use the generic gather path (scenes whose transforms change
    # per frame re-upload, matching the reference's staged SSBO update).
    # Layout: component-major, corner-major columns (see setup.py "SoA
    # twins"): row j of corner_world is world component j, columns
    # [c*T, (c+1)*T) are corner c of every triangle.
    corner_world_o: jnp.ndarray = None   # (4, 3*T1) homogeneous world pos
    corner_attr_o: jnp.ndarray = None    # (5, 3*T1) uv(2) + world normal(3)
    corner_world_m: jnp.ndarray = None   # (4, 3*T2)
    corner_attr_m: jnp.ndarray = None    # (5, 3*T2)


def _lod_for(tex, uv, albedo_idx):
    """Mip LOD per pixel. Uniform mode: one static base size; native
    mode: each pixel's own texture dims (the reference's per-texture()
    hardware derivative, scene.cpp:104-161)."""
    if tex.meta is None:
        return quad_derivative_lod(uv, tex.sizes[0])
    wh = small_lookup(tex.base_wh, jnp.maximum(albedo_idx, 0))
    return quad_derivative_lod_native(uv, wh)


@jax.jit
def _corner_tables(positions, normals, uvs, vert_transform, transforms,
                   normal_mats, tri):
    """One-time static pre-expansion: per-corner homogeneous world
    positions (4, 3T) + uv/world-normal corner attributes (5, 3T), in
    the component-major corner-major layout the SoA raster front end
    consumes (setup.py SoA twins; columns [c*T, (c+1)*T) = corner c).

    Uses the exact same ops as transform_vertices/transform_normals so
    the per-frame fast path (VP @ corner_world_t) computes the same
    length-4 dot pairs as the generic path's (world @ VP^T)[indices]."""
    mats = transforms[vert_transform]
    pos_h = jnp.concatenate(
        [positions, jnp.ones((*positions.shape[:-1], 1), positions.dtype)],
        axis=-1,
    )
    world = jnp.einsum("vij,vj->vi", mats, pos_h, precision="highest")
    world_n = transform_normals(normals, vert_transform, normal_mats)
    vattr5 = jnp.concatenate([uvs, world_n], axis=-1)
    t = tri.shape[0]
    cw_t = world[tri].transpose(2, 1, 0).reshape(4, 3 * t)
    at_t = vattr5[tri].transpose(2, 1, 0).reshape(5, 3 * t)
    return cw_t, at_t


def upload_scene(scene: CompiledScene) -> SceneDevice:
    """device_put analog of the reference's staged scene upload
    (scene.cpp:270-303 + TransferCmdPool)."""
    mask = scene.mat_clip_alpha[np.maximum(scene.tri_material, 0)] > 0
    mask &= scene.tri_material >= 0
    dev = SceneDevice(
        positions=jnp.asarray(scene.positions),
        normals=jnp.asarray(scene.normals),
        uvs=jnp.asarray(scene.uvs),
        vert_transform=jnp.asarray(scene.vert_transform),
        transforms=jnp.asarray(scene.transforms),
        normal_mats=jnp.asarray(scene.normal_mats),
        tri_opaque=jnp.asarray(scene.tri_indices[~mask]),
        tri_opaque_mat=jnp.asarray(scene.tri_material[~mask]),
        tri_masked=jnp.asarray(scene.tri_indices[mask]),
        tri_masked_mat=jnp.asarray(scene.tri_material[mask]),
        mat_albedo_tex=jnp.asarray(scene.mat_albedo_tex),
        mat_mr_tex=jnp.asarray(scene.mat_mr_tex),
        tex=(pack_texture_array_native(
                 list(scene.tex_images), scene.tex_wrap,
                 mat_albedo_tex=scene.mat_albedo_tex,
                 mat_mr_tex=scene.mat_mr_tex)
             if getattr(scene, "tex_images", None) is not None
             else pack_texture_array(
                 scene.tex_mips, scene.tex_wrap,
                 mat_albedo_tex=scene.mat_albedo_tex,
                 mat_mr_tex=scene.mat_mr_tex)),
    )
    cw_o, ca_o = _corner_tables(
        dev.positions, dev.normals, dev.uvs, dev.vert_transform,
        dev.transforms, dev.normal_mats, dev.tri_opaque)
    cw_m, ca_m = (_corner_tables(
        dev.positions, dev.normals, dev.uvs, dev.vert_transform,
        dev.transforms, dev.normal_mats, dev.tri_masked)
        if int(dev.tri_masked.shape[0]) > 0 else (None, None))
    return dev._replace(corner_world_o=cw_o, corner_attr_o=ca_o,
                        corner_world_m=cw_m, corner_attr_m=ca_m)


class GBuffer(NamedTuple):
    albedo: jnp.ndarray
    normal: jnp.ndarray
    material: jnp.ndarray
    velocity: jnp.ndarray
    depth: jnp.ndarray
    # () i32 — bin pairs dropped by the raster front end across all phases.
    # Nonzero means geometry silently vanished (pair_factor too small);
    # bench.py and tests assert this stays 0.
    overflow: jnp.ndarray


DEFAULT_ALBEDO = (0.5, 0.5, 0.5, 1.0)   # opaque_taa.frag:31
DEFAULT_MATERIAL = (0.5, 0.9, 0.5, 0.5)  # opaque_taa.frag:43


def _resolve_attrs(vis):
    """Per-pixel interpolated attributes {uv, normal, prev_clip, mat_id}
    from the raster's resolved channels (raster/pipeline.py)."""
    out = vis.resolved
    return {
        "uv": out[..., 0:2],
        "normal": out[..., 2:5],
        "prev_clip": out[..., 5:9],
        "mat_id": out[..., 9].astype(jnp.int32),
    }


def _material_texture(tex, mat_tex_idx, uv, lod, default):
    """Sample the per-pixel material texture; fall back to the reference's
    constant when the material has none (index -1)."""
    valid = mat_tex_idx >= 0
    color = sample_texture_array(
        tex, jnp.maximum(mat_tex_idx, 0), uv, lod
    )
    return jnp.where(
        valid[..., None], color,
        jnp.asarray(default, jnp.float32)[None, None, :],
    )


@register("gbuf_opaque_taa")
def render_gbuffer(
    scene: SceneDevice,
    view_proj,
    prev_view_proj,
    jitter,
    *,
    width: int,
    height: int,
    quantize: bool = True,
    use_pallas: bool = True,
    interpret: bool = False,
    mask_peel_layers: int = 1,
    full_height: int = None,
    row_offset=None,
    trilinear: bool = False,
) -> GBuffer:
    """full_height/row_offset: band-viewport mode (multi-chip pixel-band
    sharding, parallel/band.py): render rows [row_offset,
    row_offset + height) of a full_height-tall framebuffer, band-exact
    (coverage/attributes bitwise equal to the same rows of a full-frame
    render).

    mask_peel_layers: how many alpha-MASK transparency layers to
    resolve. 1 (default) = closest masked fragment only; 2 adds a
    depth-peeled second pass so a masked fragment whose alpha==0 reveals
    the NEXT masked surface behind it instead of skipping straight to
    the opaque layer — closing the gap to the reference's per-fragment
    discard (opaque_taa.frag:32-34) for two stacked masked surfaces."""
    vp = jnp.asarray(view_proj)
    prev_vp = jnp.asarray(prev_view_proj)

    # Static-scene front end: per-corner world tables were pre-expanded at
    # upload, so the per-frame transform is ONE matmul per subset and the
    # raster front end runs gather-free on dense components (row-wise
    # matmul commutes with the static gathers). Independent of the
    # raster route (tile kernel or oracle).
    fast = scene.corner_world_o is not None

    from vkr.raster.setup import corner_transform_t as _corner_clip

    if fast:
        clip = prev_clip = world_n = None
        clip_o = _corner_clip(scene.corner_world_o, vp)
        cattr_o = jnp.concatenate(
            [scene.corner_attr_o, _corner_clip(scene.corner_world_o,
                                               prev_vp)], axis=0)
    else:
        clip = transform_vertices(
            scene.positions, scene.vert_transform, scene.transforms, vp
        )
        prev_clip = transform_vertices(
            scene.positions, scene.vert_transform, scene.transforms, prev_vp
        )
        world_n = transform_normals(
            scene.normals, scene.vert_transform, scene.normal_mats
        )
        clip_o = cattr_o = None

    # Per-vertex attribute pack for the shared resolve planes:
    # uv (2) + world normal (3) + previous clip (4).
    vattrs = (None if fast else
              jnp.concatenate([scene.uvs, world_n, prev_clip], axis=-1))
    rkw = dict(width=width, height=height, jitter=jitter,
               use_pallas=use_pallas, interpret=interpret,
               vertex_attrs=vattrs, full_height=full_height,
               y_offset=row_offset)
    vis = rasterize(clip, scene.tri_opaque,
                    tri_mat=scene.tri_opaque_mat,
                    corners_t=clip_o, corner_attrs_t=cattr_o, **rkw)
    depth = vis.depth
    mask = vis.tri_id >= 0
    overflow = vis.overflow
    attrs = _resolve_attrs(vis)

    has_masked = int(scene.tri_masked.shape[0]) > 0
    if has_masked:
        if fast:
            clip_m = _corner_clip(scene.corner_world_m, vp)
            cattr_m = jnp.concatenate(
                [scene.corner_attr_m, _corner_clip(scene.corner_world_m,
                                                   prev_vp)], axis=0)
        else:
            clip_m = cattr_m = None
        vis_b = rasterize(clip, scene.tri_masked,
                          tri_mat=scene.tri_masked_mat,
                          corners_t=clip_m, corner_attrs_t=cattr_m,
                          keep_prepared=(use_pallas
                                         and mask_peel_layers >= 2),
                          **rkw)
        overflow = overflow + vis_b.overflow
        attrs_b = _resolve_attrs(vis_b)
        # Alpha test the masked layer (discard iff sampled alpha == 0,
        # opaque_taa.frag:32-34), then depth-merge with the opaque layer.
        # Alpha-only 4-byte quad rows: 2.4x cheaper than a full sample.
        aidx_b = small_lookup(scene.mat_albedo_tex,
                              jnp.maximum(attrs_b["mat_id"], 0))
        lod_b = _lod_for(scene.tex, attrs_b["uv"], aidx_b)
        alpha_b = jnp.where(
            aidx_b >= 0,
            sample_alpha_sparse(scene.tex, jnp.maximum(aidx_b, 0),
                                attrs_b["uv"], lod_b,
                                (vis_b.tri_id >= 0) & (aidx_b >= 0)),
            DEFAULT_ALBEDO[3],
        )
        keep_b = (
            (vis_b.tri_id >= 0)
            & (alpha_b != 0.0)
            & (vis_b.depth <= depth)
        )
        if mask_peel_layers >= 2:
            # Second transparency layer: where the closest masked
            # fragment was alpha-discarded, peel to the masked fragment
            # strictly behind it and alpha-test that one too.
            discarded = (vis_b.tri_id >= 0) & (alpha_b == 0.0)
            # The peel pass differs from the first masked pass ONLY in
            # peel_depth: rerun just the tile walk over the retained
            # front-end products instead of redoing clip/setup/bin/rows.
            vis_b2 = rasterize(clip, scene.tri_masked,
                               tri_mat=scene.tri_masked_mat,
                               corners_t=clip_m, corner_attrs_t=cattr_m,
                               peel_depth=vis_b.depth,
                               prepared=vis_b if use_pallas else None,
                               **rkw)
            overflow = overflow + vis_b2.overflow
            attrs_b2 = _resolve_attrs(vis_b2)
            aidx_b2 = small_lookup(scene.mat_albedo_tex,
                                   jnp.maximum(attrs_b2["mat_id"], 0))
            lod_b2 = _lod_for(scene.tex, attrs_b2["uv"], aidx_b2)
            alpha_b2 = jnp.where(
                aidx_b2 >= 0,
                sample_alpha_sparse(scene.tex, jnp.maximum(aidx_b2, 0),
                                    attrs_b2["uv"], lod_b2,
                                    discarded & (aidx_b2 >= 0)),
                DEFAULT_ALBEDO[3],
            )
            keep_b2 = (
                discarded
                & (vis_b2.tri_id >= 0)
                & (alpha_b2 != 0.0)
                & (vis_b2.depth <= depth)
            )
            vis_depth_b = jnp.where(keep_b2, vis_b2.depth, vis_b.depth)
            keep_b = keep_b | keep_b2
            k2 = keep_b2[..., None]
            attrs_b = {
                "uv": jnp.where(k2, attrs_b2["uv"], attrs_b["uv"]),
                "normal": jnp.where(k2, attrs_b2["normal"],
                                    attrs_b["normal"]),
                "prev_clip": jnp.where(k2, attrs_b2["prev_clip"],
                                       attrs_b["prev_clip"]),
                "mat_id": jnp.where(keep_b2, attrs_b2["mat_id"],
                                    attrs_b["mat_id"]),
            }
        else:
            vis_depth_b = vis_b.depth
        depth = jnp.where(keep_b, vis_depth_b, depth)
        mask = mask | keep_b
        k1 = keep_b[..., None]
        attrs = {
            "uv": jnp.where(k1, attrs_b["uv"], attrs["uv"]),
            "normal": jnp.where(k1, attrs_b["normal"], attrs["normal"]),
            "prev_clip": jnp.where(k1, attrs_b["prev_clip"],
                                   attrs["prev_clip"]),
            "mat_id": jnp.where(keep_b, attrs_b["mat_id"],
                                attrs["mat_id"]),
        }

    mat_id = jnp.where(mask, attrs["mat_id"], -1)
    uv = attrs["uv"]
    lod = _lod_for(scene.tex, uv, jnp.where(
        mat_id >= 0,
        small_lookup(scene.mat_albedo_tex, jnp.maximum(mat_id, 0)), -1,
    ))

    aidx = jnp.where(
        mat_id >= 0,
        small_lookup(scene.mat_albedo_tex, jnp.maximum(mat_id, 0)), -1,
    )
    midx = jnp.where(
        mat_id >= 0,
        small_lookup(scene.mat_mr_tex, jnp.maximum(mat_id, 0)), -1,
    )
    if scene.tex.pair_quad is not None:
        # One 32-byte gather fetches BOTH material textures per pixel.
        alb_s, mr_s = sample_material_pair(scene.tex, mat_id, uv, lod,
                                           trilinear=trilinear)
        dflt_a = jnp.asarray(DEFAULT_ALBEDO, jnp.float32)[None, None, :]
        dflt_m = jnp.asarray(DEFAULT_MATERIAL, jnp.float32)[None, None, :]
        albedo = jnp.where((aidx >= 0)[..., None], alb_s, dflt_a)
        material = jnp.where((midx >= 0)[..., None], mr_s, dflt_m)
    else:
        albedo = _material_texture(scene.tex, aidx, uv, lod,
                                   DEFAULT_ALBEDO)
        material = _material_texture(scene.tex, midx, uv, lod,
                                     DEFAULT_MATERIAL)
    # SRGB textures: hardware decodes on sample (scene loads all images as
    # RGBA8_SRGB, images.cpp:22); alpha stays linear.
    albedo = albedo.at[..., :3].set(srgb_to_linear(albedo[..., :3]))
    material = material.at[..., :3].set(srgb_to_linear(material[..., :3]))

    n = attrs["normal"]
    n = n / jnp.linalg.norm(n, axis=-1, keepdims=True).clip(1e-20)
    normal_oct = encode_normal(n)

    prev_c = attrs["prev_clip"]
    prev_ndc = prev_c[..., :2] / jnp.where(
        jnp.abs(prev_c[..., 3:4]) < 1e-20, 1e-20, prev_c[..., 3:4]
    )
    # Current unjittered NDC is analytic: the raster covered this pixel with
    # jittered geometry, so interpolated pos_after == pixel ndc - jitter.
    fh = full_height or height
    r0 = 0 if row_offset is None else row_offset
    xs = (jnp.arange(width, dtype=jnp.float32) + 0.5) / width * 2.0 - 1.0
    ys = ((r0 + jnp.arange(height, dtype=jnp.float32)) + 0.5) / fh \
        * 2.0 - 1.0
    cur_ndc = jnp.stack(
        jnp.meshgrid(xs, ys), axis=-1
    ) - jnp.asarray(jitter)[None, None, :]
    velocity = 0.5 * (prev_ndc - cur_ndc)  # opaque_taa.frag:46

    # Background: clear colors 0 (clear_color_attachments(0,0,0,0)).
    m3 = mask[..., None]
    albedo = jnp.where(m3, albedo, 0.0)
    material = jnp.where(m3, material, 0.0)
    normal_oct = jnp.where(m3, normal_oct, 0.0)
    velocity = jnp.where(m3, velocity, 0.0)

    if quantize:
        albedo = albedo.at[..., :3].set(
            srgb_to_linear(
                quantize_unorm(linear_to_srgb(albedo[..., :3]), 8)
            )
        )
        material = material.at[..., :3].set(
            srgb_to_linear(
                quantize_unorm(linear_to_srgb(material[..., :3]), 8)
            )
        )
        normal_oct = quantize_unorm(normal_oct, 16)
        velocity = quantize_f16(velocity)
        depth = quantize_d24(depth)

    return GBuffer(
        albedo=albedo,
        normal=normal_oct,
        material=material,
        velocity=velocity,
        depth=depth,
        overflow=overflow,
    )


@register("gbuf_opaque")
def render_gbuffer_legacy(
    scene: SceneDevice,
    view_proj,
    *,
    width: int,
    height: int,
    quantize: bool = True,
    use_pallas: bool = True,
    interpret: bool = False,
    trilinear: bool = False,
) -> GBuffer:
    """Legacy non-TAA G-buffer (gbuf/opaque.{vert,frag}; manifest entry
    gbuf_opaque, src/shaders/config.json): the unjittered raster path
    with no motion vectors — gl_Position carries no jitter and the
    fragment stage writes only albedo/normal/material (+depth). Analog:
    the TAA raster with zero jitter and prev == cur projection; the
    velocity plane (which the legacy pass does not produce) is exactly
    zero."""
    gbuf = render_gbuffer(
        scene, view_proj, view_proj, jnp.zeros(2, jnp.float32),
        width=width, height=height, quantize=quantize,
        use_pallas=use_pallas, interpret=interpret,
        trilinear=trilinear,
    )
    return gbuf._replace(velocity=jnp.zeros_like(gbuf.velocity))
