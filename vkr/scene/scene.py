"""Scene compilation: glTF -> device-ready SoA arrays.

The analog of the reference's CompiledScene (scene/scene.hpp:63-87): one
merged vertex pool + index pool, material table, texture set. Differences
driven by array-program idioms:
  * instances are flattened at compile time (per-vertex transform index
    instead of per-draw push constants, scene_renderer.cpp:200-215);
  * the bindless texture array (set 1, scene_renderer.cpp:84-103) becomes a
    fixed-size RGBA8 texture array with a full mip pyramid, one array per
    mip level;
  * per-frame transform upload (update_scene, scene_renderer.cpp:121-131)
    becomes refreshing the (N, 4, 4) transform table.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np

from vkr.mathlib.transforms import normal_matrix
from vkr.scene import gltf as _gltf


class CompiledScene(NamedTuple):
    # Geometry (instance-expanded, model space)
    positions: np.ndarray      # (V, 3) f32
    normals: np.ndarray        # (V, 3) f32
    uvs: np.ndarray            # (V, 2) f32
    tri_indices: np.ndarray    # (T, 3) i32 absolute vertex ids
    tri_material: np.ndarray   # (T,) i32, -1 = fallback material
    vert_transform: np.ndarray  # (V,) i32 -> transforms row
    # Per-draw-call transforms (host-refreshable)
    transforms: np.ndarray     # (N, 4, 4) f32 world matrices
    normal_mats: np.ndarray    # (N, 4, 4) f32
    # Material SoA (reference scene.cpp:171-181)
    mat_albedo_tex: np.ndarray   # (M,) i32, -1 = none
    mat_mr_tex: np.ndarray       # (M,) i32
    mat_clip_alpha: np.ndarray   # (M,) i32 0/1
    mat_alpha_cutoff: np.ndarray  # (M,) f32
    # Texture array mip pyramid: tuple of (NT, S>>l, S>>l, 4) u8
    tex_mips: Tuple[np.ndarray, ...]
    tex_wrap: np.ndarray       # (NT,) i32 (gltf.WRAP_*)
    # native-size mode (compile_scene(native_sizes=True)): per-texture
    # images at their ORIGINAL resolutions/aspect (scene.cpp:104-161
    # samples each texture at native size); tex_mips then holds the
    # uniform fallback used only when packing rejects the native set
    tex_images: "tuple | None" = None

    @property
    def num_triangles(self) -> int:
        return self.tri_indices.shape[0]


def build_mip_pyramid(tex_array: np.ndarray) -> Tuple[np.ndarray, ...]:
    """(NT, S, S, 4) u8 -> tuple of mips down to 1x1 via 2x2 box filter
    (the reference's vkCmdBlitImage linear mip-gen, scene/images.cpp:93+).

    Uses the native C++ pipeline (vkr/native) when built."""
    from vkr import native

    if native.available():
        mips = [tex_array]
        cur = tex_array
        while cur.shape[1] > 1:
            cur = native.mip_downsample_rgba8(cur)
            mips.append(cur)
        return tuple(mips)

    mips = [tex_array]
    cur = tex_array.astype(np.uint16)
    while cur.shape[1] > 1:
        n, s, _, c = cur.shape
        cur = (
            cur.reshape(n, s // 2, 2, s // 2, 2, c).sum(axis=(2, 4)) + 2
        ) // 4
        mips.append(cur.astype(np.uint8))
    return tuple(mips)


def _resize_rgba(img: np.ndarray, size: int) -> np.ndarray:
    from vkr import native

    if img.shape[0] == size and img.shape[1] == size:
        return img
    if native.available():
        return native.resize_rgba8(img, size, size)
    return _resize_bilinear(img, size, size)


def _resize_bilinear(img: np.ndarray, h2: int, w2: int) -> np.ndarray:
    """(h, w, c) u8 -> (h2, w2, c) u8, bilinear at pixel centers with
    edge clamp."""
    h, w = img.shape[:2]

    def axis(n_out, n_in):
        x = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
        x0 = np.clip(np.floor(x).astype(np.int64), 0, n_in - 1)
        x1 = np.minimum(x0 + 1, n_in - 1)
        f = np.clip(x - x0, 0.0, 1.0).astype(np.float32)
        return x0, x1, f

    y0, y1, fy = axis(h2, h)
    x0, x1, fx = axis(w2, w)
    a = img.astype(np.float32)
    top = a[y0][:, x0] * (1 - fx)[None, :, None] + a[y0][:, x1] * fx[None, :, None]
    bot = a[y1][:, x0] * (1 - fx)[None, :, None] + a[y1][:, x1] * fx[None, :, None]
    out = top * (1 - fy)[:, None, None] + bot * fy[:, None, None]
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def compile_scene(
    scene: _gltf.GltfScene, tex_size: int = 256,
    native_sizes: bool = False,
) -> CompiledScene:
    """tex_size: uniform square resize target — or, with
    native_sizes=True, the MAX edge (larger textures downscale by
    integer factors, aspect preserved; everything else keeps its
    original resolution, like the reference's per-texture images)."""
    positions, normals, uvs = [], [], []
    tri_indices, tri_material, vert_transform = [], [], []
    transforms, normal_mats = [], []
    v_base = 0

    for draw_id, dc in enumerate(scene.draw_calls):
        transforms.append(dc.transform.astype(np.float32))
        normal_mats.append(normal_matrix(dc.transform))
        for prim in scene.meshes[dc.mesh]:
            v0, v1 = prim.vertex_offset, None
            # vertex range for this prim: contiguous by construction
            count_idx = prim.index_count
            idx = scene.indices[
                prim.index_offset : prim.index_offset + count_idx
            ].astype(np.int64)
            n_verts = int(idx.max()) + 1 if len(idx) else 0
            sl = slice(prim.vertex_offset, prim.vertex_offset + n_verts)
            positions.append(scene.positions[sl])
            normals.append(scene.normals[sl])
            uvs.append(scene.uvs[sl])
            vert_transform.append(np.full(n_verts, draw_id, np.int32))
            tri = (idx.reshape(-1, 3) + v_base).astype(np.int32)
            tri_indices.append(tri)
            tri_material.append(
                np.full(len(tri), prim.material, np.int32)
            )
            v_base += n_verts

    n_tex = len(scene.texture_image)
    tex_array = np.zeros((max(n_tex, 1), tex_size, tex_size, 4), np.uint8)
    tex_array[..., 3] = 255
    tex_images = None
    if native_sizes:
        tex_images = []
        for t in range(max(n_tex, 1)):
            img_id = (scene.texture_image[t]
                      if t < len(scene.texture_image) else -1)
            if 0 <= img_id < len(scene.images):
                img = np.asarray(scene.images[img_id], np.uint8)
                # integer-factor downscale to respect the max edge,
                # aspect preserved
                f = -(-max(img.shape[0], img.shape[1]) // tex_size)
                if f > 1:
                    h2 = max(img.shape[0] // f, 1)
                    w2 = max(img.shape[1] // f, 1)
                    img = img[: h2 * f, : w2 * f].reshape(
                        h2, f, w2, f, 4).astype(np.uint32).mean(
                        axis=(1, 3)).astype(np.uint8)
            else:
                img = np.full((1, 1, 4), 255, np.uint8)
            tex_images.append(np.ascontiguousarray(img))
        tex_images = tuple(tex_images)
    for t, img_id in enumerate(scene.texture_image):
        if 0 <= img_id < len(scene.images):
            tex_array[t] = _resize_rgba(scene.images[img_id], tex_size)

    materials = scene.materials or [_gltf.Material()]

    def cat(parts, shape, dtype):
        if parts and sum(len(p) for p in parts):
            return np.concatenate(parts, axis=0).astype(dtype)
        return np.zeros(shape, dtype)

    return CompiledScene(
        positions=cat(positions, (0, 3), np.float32),
        normals=cat(normals, (0, 3), np.float32),
        uvs=cat(uvs, (0, 2), np.float32),
        tri_indices=cat(tri_indices, (0, 3), np.int32),
        tri_material=cat(tri_material, (0,), np.int32),
        vert_transform=cat(vert_transform, (0,), np.int32),
        transforms=np.stack(transforms) if transforms else np.eye(
            4, dtype=np.float32)[None],
        normal_mats=np.stack(normal_mats) if normal_mats else np.eye(
            4, dtype=np.float32)[None],
        mat_albedo_tex=np.array(
            [m.albedo_tex for m in materials], np.int32
        ),
        mat_mr_tex=np.array([m.mr_tex for m in materials], np.int32),
        mat_clip_alpha=np.array(
            [int(m.clip_alpha) for m in materials], np.int32
        ),
        mat_alpha_cutoff=np.array(
            [m.alpha_cutoff for m in materials], np.float32
        ),
        tex_mips=build_mip_pyramid(tex_array),
        tex_wrap=np.asarray(scene.texture_wrap or [0], np.int32),
        tex_images=tex_images,
    )


def load_scene(path: str, tex_size: int = 256,
               native_sizes: bool = False) -> CompiledScene:
    """load_tinygltf_scene analog (scene.cpp:330-360)."""
    return compile_scene(_gltf.load_gltf(path), tex_size=tex_size,
                         native_sizes=native_sizes)
