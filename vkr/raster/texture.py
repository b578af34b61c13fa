"""Texture array sampling — the bindless-descriptor analog.

The reference binds all scene textures as one variable-count descriptor
array (set 1 `sampler2D material_textures[]`, scene_renderer.cpp:84-103)
and samples with per-fragment indices. Here all textures live in one flat
HBM array with a packed mip pyramid; sampling is gather + lerp arithmetic
over the pixel grid with per-pixel texture index, LOD and wrap mode
(DEFAULT_SAMPLER is linear/linear with linear mipmaps, samplers.hpp:36-50;
glTF scene samplers use REPEAT, remapped per texture like
scene.cpp:104-161).

Packed layouts (each one row gather per sample):
  * `flat_quad` (16 B) — one gather per bilinear tap (4 texels pre-packed
    with wrap-aware neighbors);
  * `alpha_quad` (4 B) — alpha-only bilinear tap for the alpha-MASK test
    (opaque_taa.frag:32-34);
  * `pair_quad` (32 B) — albedo+metallic-roughness quads zipped per
    material so deferred G-buffer texturing is ONE gather per pixel
    instead of two.
Whether these still pay on the GPU, where a gather is an ordinary cached
load, is an open question (ROADMAP D3). Tiny per-material/per-texture
tables are read through `small_lookup`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np

from vkr.scene.gltf import WRAP_CLAMP, WRAP_REPEAT


import dataclasses

import jax


def small_lookup(table, idx):
    """Per-pixel read of a tiny per-material/per-texture table (a plain
    gather; kept as a helper so the access pattern stays greppable)."""
    return table[idx]


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class TextureArray:
    """Packed texture-array pytree. Device arrays are children; the mip
    layout (offsets/sizes/flat_len) is static metadata so it survives
    jit argument passing as compile-time constants."""

    flat: jnp.ndarray      # (NT * FLAT, 4) u8 — all textures, mips packed
    # wrap-aware 2x2 quads; None when the pair path covers all sampling
    flat_quad: Optional[jnp.ndarray]  # (NT * FLAT, 16) u8
    wrap: jnp.ndarray      # (NT,) i32
    offsets: Tuple[int, ...]  # static: texel offset of each mip level
    sizes: Tuple[int, ...]    # static: edge length of each mip level
    flat_len: int             # FLAT = sum(sizes^2)
    uniform_wrap: "int | None" = None  # static: set when all textures agree
    # alpha-only quads for the MASK test (4 B rows)
    alpha_quad: Optional[jnp.ndarray] = None  # (NT * FLAT, 4) u8
    # per-material albedo+MR zipped quads (32 B rows) + material -> pair
    pair_quad: Optional[jnp.ndarray] = None   # (NP * FLAT, 32) u8
    mat_pair: Optional[jnp.ndarray] = None    # (M,) i32, -1 = no pair
    pair_wrap: Optional[jnp.ndarray] = None   # (NP,) i32
    # ---- native-size mode (meta is not None): per-texture resolutions
    # and aspect preserved (scene.cpp:104-161); offsets/sizes/flat_len
    # above are unused. meta rows are [abs_offset, w, h, wrap] per
    # (texture, level), levels beyond a texture's chain repeating its
    # 1x1 tail so per-pixel level clamps are free.
    meta: Optional[jnp.ndarray] = None        # (NT * L, 4) i32
    pair_meta: Optional[jnp.ndarray] = None   # (NP * L, 4) i32
    base_wh: Optional[jnp.ndarray] = None     # (NT, 2) i32 level-0 dims
    n_levels: int = 0                         # static: L (native mode)

    def tree_flatten(self):
        return (
            self.flat, self.flat_quad, self.wrap, self.alpha_quad,
            self.pair_quad, self.mat_pair, self.pair_wrap,
            self.meta, self.pair_meta, self.base_wh,
        ), (self.offsets, self.sizes, self.flat_len, self.uniform_wrap,
            self.n_levels)

    @classmethod
    def tree_unflatten(cls, aux, children):
        (flat, flat_quad, wrap, alpha_quad, pair_quad, mat_pair,
         pair_wrap, meta, pair_meta, base_wh) = children
        offsets, sizes, flat_len, uniform_wrap, n_levels = aux
        return cls(flat=flat, flat_quad=flat_quad, wrap=wrap,
                   offsets=offsets, sizes=sizes, flat_len=flat_len,
                   uniform_wrap=uniform_wrap, alpha_quad=alpha_quad,
                   pair_quad=pair_quad, mat_pair=mat_pair,
                   pair_wrap=pair_wrap, meta=meta, pair_meta=pair_meta,
                   base_wh=base_wh, n_levels=n_levels)


def _quad_neighbors_batch(imgs, repeat_mask):
    """Wrap-aware +x/+y/+xy neighbors for a whole (NT, S, S, 4) level at
    once (vectorized: the per-texture python loop cost ~3 min at
    69 x 1024^2). Uniform-wrap sets (e.g. Sponza: all REPEAT) skip the
    12 full-size np.where blends (~4x less host bandwidth)."""
    if repeat_mask.all():
        xr = np.roll(imgs, -1, axis=2)
        yd = np.roll(imgs, -1, axis=1)
        return xr, yd, np.roll(xr, -1, axis=1)
    if not repeat_mask.any():
        xr = np.concatenate([imgs[:, :, 1:], imgs[:, :, -1:]], axis=2)
        yd = np.concatenate([imgs[:, 1:], imgs[:, -1:]], axis=1)
        return xr, yd, np.concatenate([xr[:, 1:], xr[:, -1:]], axis=1)
    xr_rep = np.roll(imgs, -1, axis=2)
    yd_rep = np.roll(imgs, -1, axis=1)
    xr_cl = np.concatenate([imgs[:, :, 1:], imgs[:, :, -1:]], axis=2)
    yd_cl = np.concatenate([imgs[:, 1:], imgs[:, -1:]], axis=1)
    m = repeat_mask[:, None, None, None]
    xr = np.where(m, xr_rep, xr_cl)
    yd = np.where(m, yd_rep, yd_cl)
    yxd = np.where(
        m, np.roll(xr_rep, -1, axis=1),
        np.concatenate([xr_cl[:, 1:], xr_cl[:, -1:]], axis=1),
    )
    return xr, yd, yxd


def _pack_texture_arrays_np(tex_mips, wrap_np, mat_albedo_tex, mat_mr_tex):
    """Pure-numpy packing body of pack_texture_array — returns a dict of
    arrays so the result can be disk-cached (core/diskcache.py; measured
    ~60 s of numpy at 69 x 1024^2)."""
    sizes = tuple(int(m.shape[1]) for m in tex_mips)
    offsets = []
    off = 0
    for s in sizes:
        offsets.append(off)
        off += s * s
    flat_len = off
    nt = tex_mips[0].shape[0]

    rep_mask = np.zeros(nt, bool)
    rep_mask[: len(wrap_np)] = wrap_np == WRAP_REPEAT
    flat = np.zeros((nt, flat_len, 4), np.uint8)
    quad = np.zeros((nt, flat_len, 16), np.uint8)
    for m, o, s in zip(tex_mips, offsets, sizes):
        flat[:, o : o + s * s] = m.reshape(nt, s * s, 4)
        xr, yd, yxd = _quad_neighbors_batch(m, rep_mask)
        quad[:, o : o + s * s] = np.concatenate(
            [m, xr, yd, yxd], axis=-1
        ).reshape(nt, s * s, 16)
    alpha = quad[..., 3::4].copy()  # (nt, flat, 4) u8 — quad alphas

    out = {
        "flat": flat.reshape(nt * flat_len, 4),
        "alpha": alpha.reshape(nt * flat_len, 4),
    }
    have_pair = False
    if mat_albedo_tex is not None and mat_mr_tex is not None:
        at = np.asarray(mat_albedo_tex, np.int32)
        mt = np.asarray(mat_mr_tex, np.int32)
        ok = True
        for a, b in zip(at, mt):
            if a >= 0 and b >= 0 and wrap_np[a] != wrap_np[b]:
                ok = False  # mixed-wrap pair: fall back to 2 gathers
        if ok:
            pairs = {}
            mat_pair_np = np.full(len(at), -1, np.int32)
            for mi, (a, b) in enumerate(zip(at, mt)):
                if a < 0 and b < 0:
                    continue
                key = (int(a), int(b))
                if key not in pairs:
                    pairs[key] = len(pairs)
                mat_pair_np[mi] = pairs[key]
            np_pairs = len(pairs)
            if np_pairs:
                pq = np.zeros((np_pairs, flat_len, 32), np.uint8)
                pw = np.zeros(np_pairs, np.int32)
                for (a, b), pi in pairs.items():
                    if a >= 0:
                        pq[pi, :, 0:16] = quad[a]
                    if b >= 0:
                        pq[pi, :, 16:32] = quad[b]
                    src = a if a >= 0 else b
                    pw[pi] = wrap_np[src] if src < len(wrap_np) else 0
                out["pair_quad"] = pq.reshape(np_pairs * flat_len, 32)
                out["mat_pair"] = mat_pair_np
                out["pair_wrap"] = pw
                have_pair = True
    if not have_pair:
        # G-buffer texturing falls back to per-texture quad gathers; only
        # then is the full 16-byte quad table needed on device (the pair
        # path samples exclusively from pair_quad + alpha, so skipping
        # this upload saves 4x flat-size bytes of HBM and startup).
        out["flat_quad"] = quad.reshape(nt * flat_len, 16)
    return out


def pack_texture_array(
    tex_mips, wrap, mat_albedo_tex=None, mat_mr_tex=None
) -> TextureArray:
    """(mip pyramids from scene.build_mip_pyramid) -> flat device layout.

    Packs each texel's wrap-aware 2x2 bilinear footprint into a 16-byte
    quad row (one gather per bilinear tap), the alpha channel of that
    footprint into a 4-byte row, and — when the material tables are given
    and each material's albedo/MR wraps agree — zipped 32-byte
    albedo+MR pair rows so G-buffer texturing is one gather per pixel.
    Packed products are disk-cached by content hash (diskcache.py)."""
    from vkr.core.diskcache import cached_npz, content_key

    sizes = tuple(int(m.shape[1]) for m in tex_mips)
    offsets = []
    off = 0
    for s in sizes:
        offsets.append(off)
        off += s * s
    flat_len = off
    wrap_np = np.asarray(wrap, np.int32)
    at = None if mat_albedo_tex is None else np.asarray(mat_albedo_tex,
                                                        np.int32)
    mt = None if mat_mr_tex is None else np.asarray(mat_mr_tex, np.int32)

    key = content_key("texpack", sizes, *(np.asarray(m) for m in tex_mips),
                      wrap_np, at, mt)
    packed = cached_npz(key, lambda: _pack_texture_arrays_np(
        tex_mips, wrap_np, at, mt))

    uniq = np.unique(wrap_np) if len(wrap_np) else np.asarray([0])
    opt = lambda k: (jnp.asarray(packed[k]) if k in packed else None)
    return TextureArray(
        flat=jnp.asarray(packed["flat"]),
        flat_quad=opt("flat_quad"),
        wrap=jnp.asarray(wrap, jnp.int32),
        offsets=tuple(offsets),
        sizes=sizes,
        flat_len=flat_len,
        uniform_wrap=int(uniq[0]) if len(uniq) == 1 else None,
        alpha_quad=jnp.asarray(packed["alpha"]),
        pair_quad=opt("pair_quad"),
        mat_pair=opt("mat_pair"),
        pair_wrap=opt("pair_wrap"),
    )


def _mip_chain_native(img, repeat: bool):
    """Per-texture mip chain at native aspect: 2x2 box filter halving
    each dim (odd dims edge-pad to even first) down to 1x1."""
    mips = [np.asarray(img, np.uint8)]
    cur = mips[0]
    while cur.shape[0] > 1 or cur.shape[1] > 1:
        h, w = cur.shape[:2]
        if h & 1:
            cur = np.concatenate([cur, cur[-1:]], axis=0)
            h += 1
        if w & 1:
            cur = np.concatenate([cur, cur[:, -1:]], axis=1)
            w += 1
        h2, w2 = max(h // 2, 1), max(w // 2, 1)
        cur = ((cur.astype(np.uint16).reshape(h2, 2, w2, 2, 4)
                .sum(axis=(1, 3)) + 2) // 4).astype(np.uint8)
        mips.append(cur)
    return mips


def _quad_neighbors_native(img, repeat: bool):
    """Wrap-aware +x/+y/+xy neighbors of one native-size level."""
    if repeat:
        xr = np.roll(img, -1, axis=1)
        yd = np.roll(img, -1, axis=0)
        return xr, yd, np.roll(xr, -1, axis=0)
    xr = np.concatenate([img[:, 1:], img[:, -1:]], axis=1)
    yd = np.concatenate([img[1:], img[-1:]], axis=0)
    return xr, yd, np.concatenate([xr[1:], xr[-1:]], axis=0)


def _pack_texture_arrays_native_np(images, wrap_np, mat_albedo_tex,
                                   mat_mr_tex):
    """Native-size packing body (disk-cached like the uniform path):
    each texture's mip chain packs contiguously into global flat/quad/
    alpha tables; (texture, level) geometry goes into a meta table so
    sampling needs ONE extra 16-byte meta gather per tap."""
    from vkr.scene.gltf import WRAP_REPEAT as _REP

    nt = len(images)
    chains = []
    for t in range(nt):
        rep = bool(wrap_np[t] == _REP) if t < len(wrap_np) else False
        chains.append(_mip_chain_native(images[t], rep))
    n_levels = max(len(c) for c in chains)

    total = sum(m.shape[0] * m.shape[1] for c in chains for m in c)
    flat = np.zeros((total, 4), np.uint8)
    quad = np.zeros((total, 16), np.uint8)
    meta = np.zeros((nt * n_levels, 4), np.int64)
    base_wh = np.zeros((nt, 2), np.int64)
    off = 0
    for t, chain in enumerate(chains):
        rep = bool(wrap_np[t] == _REP) if t < len(wrap_np) else False
        base_wh[t] = (chain[0].shape[1], chain[0].shape[0])
        for l in range(n_levels):
            m = chain[min(l, len(chain) - 1)]
            h, w = m.shape[:2]
            if l < len(chain):
                xr, yd, yxd = _quad_neighbors_native(m, rep)
                n = h * w
                flat[off : off + n] = m.reshape(n, 4)
                quad[off : off + n] = np.concatenate(
                    [m, xr, yd, yxd], axis=-1).reshape(n, 16)
                meta[t * n_levels + l] = (
                    off, w, h, wrap_np[t] if t < len(wrap_np) else 0)
                off += n
            else:
                # clamp: repeat the 1x1 tail's meta row
                meta[t * n_levels + l] = meta[t * n_levels + l - 1]
    alpha = quad[:, 3::4].copy()

    out = {
        "flat": flat,
        "alpha": alpha,
        "meta": meta.astype(np.int32),
        "base_wh": base_wh.astype(np.int32),
        "n_levels": np.int64(n_levels),
    }
    have_pair = False
    if mat_albedo_tex is not None and mat_mr_tex is not None:
        at = np.asarray(mat_albedo_tex, np.int64)
        mt = np.asarray(mat_mr_tex, np.int64)

        def pairable(a, b):
            if a < 0 or b < 0:
                return a >= 0 or b >= 0
            return (wrap_np[a] == wrap_np[b]
                    and images[a].shape[:2] == images[b].shape[:2])

        pairs = {}
        mat_pair_np = np.full(len(at), -1, np.int64)
        ok_all = True
        for mi, (a, b) in enumerate(zip(at, mt)):
            if a < 0 and b < 0:
                continue
            if not pairable(a, b):
                ok_all = False
                continue
            key = (int(a), int(b))
            if key not in pairs:
                pairs[key] = len(pairs)
            mat_pair_np[mi] = pairs[key]
        if not ok_all:
            # all-or-nothing like the uniform path: a half-paired
            # material set would route unpairable materials through
            # pair slot 0 (wrong textures) — fall back entirely
            pairs = {}
        if pairs:
            # pair rows zip the two textures' quad rows level by level
            pair_rows = []
            pair_meta = np.zeros((len(pairs) * n_levels, 4), np.int64)
            poff = 0
            for (a, b), pi in sorted(pairs.items(), key=lambda kv: kv[1]):
                src = a if a >= 0 else b
                chain = chains[src]
                for l in range(n_levels):
                    li = min(l, len(chain) - 1)
                    h, w = chain[li].shape[:2]
                    n = h * w
                    if l < len(chain):
                        row = np.zeros((n, 32), np.uint8)
                        for tex, base in ((a, 0), (b, 16)):
                            if tex >= 0:
                                toff = int(meta[tex * n_levels + li, 0])
                                row[:, base : base + 16] =                                     quad[toff : toff + n]
                        pair_rows.append(row)
                        pair_meta[pi * n_levels + l] = (
                            poff, w, h,
                            wrap_np[src] if src < len(wrap_np) else 0)
                        poff += n
                    else:
                        pair_meta[pi * n_levels + l] =                             pair_meta[pi * n_levels + l - 1]
            out["pair_quad"] = np.concatenate(pair_rows, axis=0)
            out["pair_meta"] = pair_meta.astype(np.int32)
            out["mat_pair"] = mat_pair_np.astype(np.int32)
            have_pair = True
        if not ok_all or not pairs:
            out["flat_quad"] = quad
        elif not have_pair:
            out["flat_quad"] = quad
    else:
        out["flat_quad"] = quad
    return out


def pack_texture_array_native(
    images, wrap, mat_albedo_tex=None, mat_mr_tex=None
) -> TextureArray:
    """Native-size packing entry: per-texture resolutions and aspect
    preserved (scene.cpp:104-161). images: list of (h, w, 4) u8."""
    from vkr.core.diskcache import cached_npz, content_key

    wrap_np = np.asarray(wrap, np.int32)
    at = None if mat_albedo_tex is None else np.asarray(
        mat_albedo_tex, np.int32)
    mt = None if mat_mr_tex is None else np.asarray(mat_mr_tex, np.int32)
    key = content_key(
        "texpack-native", tuple(im.shape for im in images),
        *[np.asarray(im) for im in images], wrap_np, at, mt)
    packed = cached_npz(key, lambda: _pack_texture_arrays_native_np(
        images, wrap_np, at, mt))

    uniq = np.unique(wrap_np) if len(wrap_np) else np.asarray([0])
    opt = lambda k: (jnp.asarray(packed[k]) if k in packed else None)
    return TextureArray(
        flat=jnp.asarray(packed["flat"]),
        flat_quad=opt("flat_quad"),
        wrap=jnp.asarray(wrap_np, jnp.int32),
        offsets=(0,),
        sizes=(int(np.asarray(packed["base_wh"])[:, 0].max()),),
        flat_len=0,
        uniform_wrap=int(uniq[0]) if len(uniq) == 1 else None,
        alpha_quad=jnp.asarray(packed["alpha"]),
        pair_quad=opt("pair_quad"),
        mat_pair=opt("mat_pair"),
        pair_wrap=None,
        meta=jnp.asarray(packed["meta"]),
        pair_meta=opt("pair_meta"),
        base_wh=jnp.asarray(packed["base_wh"]),
        n_levels=int(np.asarray(packed["n_levels"]).reshape(-1)[0]),
    )


def _level_lookup(table, level):
    """Tiny-static-table select by per-pixel level."""
    out = jnp.full(level.shape, table[0], jnp.int32)
    for l in range(1, len(table)):
        out = jnp.where(level == l, table[l], out)
    return out


def quad_derivative_lod(uv, base_size: int):
    """Hardware-style 2x2 quad derivatives -> mip LOD per pixel.

    Matches GPU behavior (including its quad-edge quirks): both pixels of a
    quad pair share the same finite difference.
    uv: (H, W, 2) in texture uv units. Returns (H, W) f32 lod.
    """
    h, w, _ = uv.shape
    # pair-shuffled differences along x and y
    uv_x = uv.reshape(h, w // 2, 2, 2)
    dx = (uv_x[:, :, 1] - uv_x[:, :, 0])  # (H, W/2, 2)
    dx = jnp.repeat(dx, 2, axis=1).reshape(h, w, 2)
    uv_y = uv.reshape(h // 2, 2, w, 2)
    dy = (uv_y[:, 1] - uv_y[:, 0])  # (H/2, W, 2)
    dy = jnp.repeat(dy[:, None], 2, axis=1).reshape(h, w, 2)
    scale = float(base_size)
    rho = jnp.maximum(
        jnp.linalg.norm(dx * scale, axis=-1),
        jnp.linalg.norm(dy * scale, axis=-1),
    )
    return jnp.log2(jnp.maximum(rho, 1e-12))


def _wrap_coord(i, size, wrap_mode):
    rep = jnp.remainder(i, size)
    clamp = jnp.clip(i, 0, size - 1)
    return jnp.where(wrap_mode == WRAP_REPEAT, rep, clamp)


def _tap_setup(tex: TextureArray, uv, level, wrap_mode):
    """Shared bilinear tap math: returns (texel index within one texture's
    flat mips, fx, fy)."""
    s = _level_lookup(tex.sizes, level)  # (H, W)
    o = _level_lookup(tex.offsets, level)
    sf = s.astype(jnp.float32)

    x = uv[..., 0] * sf - 0.5
    y = uv[..., 1] * sf - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = x - x0
    fy = y - y0
    x0 = x0.astype(jnp.int32)
    y0 = y0.astype(jnp.int32)
    # Clamp mode collapses both taps onto texel 0 at the low edge.
    fx = jnp.where((wrap_mode == WRAP_CLAMP) & (x0 < 0), 0.0, fx)[..., None]
    fy = jnp.where((wrap_mode == WRAP_CLAMP) & (y0 < 0), 0.0, fy)[..., None]
    xi = _wrap_coord(x0, s, wrap_mode)
    yi = _wrap_coord(y0, s, wrap_mode)
    return o + yi * s + xi, fx, fy


def _tap_setup_native(meta_rows, uv):
    """Native-mode bilinear tap math from gathered (texture, level) meta
    rows [abs_offset, w, h, wrap]: returns (ABSOLUTE texel row index,
    fx, fy)."""
    off = meta_rows[..., 0]
    w = meta_rows[..., 1]
    h = meta_rows[..., 2]
    wrap_mode = meta_rows[..., 3]
    wf = w.astype(jnp.float32)
    hf = h.astype(jnp.float32)
    x = uv[..., 0] * wf - 0.5
    y = uv[..., 1] * hf - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = x - x0
    fy = y - y0
    x0 = x0.astype(jnp.int32)
    y0 = y0.astype(jnp.int32)
    fx = jnp.where((wrap_mode == WRAP_CLAMP) & (x0 < 0), 0.0, fx)[..., None]
    fy = jnp.where((wrap_mode == WRAP_CLAMP) & (y0 < 0), 0.0, fy)[..., None]
    xi = _wrap_coord(x0, w, wrap_mode)
    yi = _wrap_coord(y0, h, wrap_mode)
    return off + yi * w + xi, fx, fy


def quad_derivative_lod_native(uv, wh):
    """quad_derivative_lod with PER-PIXEL texture dims (native-size
    mode): wh (H, W, 2) i32 level-0 dims of each pixel's texture."""
    h, w, _ = uv.shape
    uv_x = uv.reshape(h, w // 2, 2, 2)
    dx = (uv_x[:, :, 1] - uv_x[:, :, 0])
    dx = jnp.repeat(dx, 2, axis=1).reshape(h, w, 2)
    uv_y = uv.reshape(h // 2, 2, w, 2)
    dy = (uv_y[:, 1] - uv_y[:, 0])
    dy = jnp.repeat(dy[:, None], 2, axis=1).reshape(h, w, 2)
    scale = wh.astype(jnp.float32)
    rho = jnp.maximum(
        jnp.linalg.norm(dx * scale, axis=-1),
        jnp.linalg.norm(dy * scale, axis=-1),
    )
    return jnp.log2(jnp.maximum(rho, 1e-12))


def _bilerp(rows, fx, fy, base: int):
    t00 = rows[..., base : base + 4]
    t10 = rows[..., base + 4 : base + 8]
    t01 = rows[..., base + 8 : base + 12]
    t11 = rows[..., base + 12 : base + 16]
    top = t00 + (t10 - t00) * fx
    bot = t01 + (t11 - t01) * fx
    return top + (bot - top) * fy


def _sample_level(tex: TextureArray, tex_idx, uv, level, wrap_mode):
    """Bilinear tap at a (per-pixel dynamic) mip level — ONE quad-row
    gather per pixel (wrap baked into the packed neighbors).

    tex_idx/(H,W) i32, uv/(H,W,2), level/(H,W) i32 -> (H, W, 4) f32 [0,1].
    """
    if tex.meta is not None:
        mrow = jnp.take(
            tex.meta,
            jnp.maximum(tex_idx, 0) * tex.n_levels + level, axis=0)
        idx, fx, fy = _tap_setup_native(mrow, uv)
    else:
        rel, fx, fy = _tap_setup(tex, uv, level, wrap_mode)
        idx = tex_idx * tex.flat_len + rel
    rows = jnp.take(tex.flat_quad, idx, axis=0).astype(jnp.float32) / 255.0
    return _bilerp(rows, fx, fy, 0)


def sample_alpha(tex: TextureArray, tex_idx, uv, lod):
    """Bilinear ALPHA tap (4-byte rows) for the alpha-MASK discard test
    (opaque_taa.frag:32-34) — 2.4x cheaper than a full quad gather."""
    n_levels = tex.n_levels if tex.meta is not None else len(tex.sizes)
    if tex.uniform_wrap is not None:
        wrap_mode = jnp.full(tex_idx.shape, tex.uniform_wrap, jnp.int32)
    else:
        wrap_mode = small_lookup(tex.wrap, jnp.maximum(tex_idx, 0))
    level = jnp.round(jnp.clip(lod, 0.0, n_levels - 1)).astype(jnp.int32)
    if tex.meta is not None:
        mrow = jnp.take(
            tex.meta,
            jnp.maximum(tex_idx, 0) * tex.n_levels + level, axis=0)
        idx, fx, fy = _tap_setup_native(mrow, uv)
    else:
        rel, fx, fy = _tap_setup(tex, uv, level, wrap_mode)
        idx = tex_idx * tex.flat_len + rel
    rows = jnp.take(tex.alpha_quad, idx, axis=0).astype(jnp.float32) / 255.0
    a00, a10, a01, a11 = (rows[..., 0], rows[..., 1], rows[..., 2],
                          rows[..., 3])
    fx = fx[..., 0]
    fy = fy[..., 0]
    top = a00 + (a10 - a00) * fx
    bot = a01 + (a11 - a01) * fx
    return top + (bot - top) * fy


def sample_alpha_sparse(tex: TextureArray, tex_idx, uv, lod, active,
                        cap_frac: float = 0.25):
    """sample_alpha restricted to (8,128) tiles containing active pixels.

    The alpha-MASK discard test only matters where a masked fragment
    exists (vis.tri_id >= 0) — a thin, spatially clustered set (foliage,
    chains), while a dense test pays for the FULL pixel count. Tiles are
    compacted with a single-key sort (tile count is ~2k — trivial),
    whole (8,128) tiles are row-gathered, and only the compacted
    tiles pay the per-index alpha gather. If more than cap_frac of the
    tiles contain active pixels, a lax.cond falls back to the dense
    test — never a wrong result.

    Returns (H, W) f32 alpha; pixels outside active tiles read 0.
    """
    h, w = tex_idx.shape
    n_levels = tex.n_levels if tex.meta is not None else len(tex.sizes)
    if tex.uniform_wrap is not None:
        wrap_mode = jnp.full(tex_idx.shape, tex.uniform_wrap, jnp.int32)
    else:
        wrap_mode = small_lookup(tex.wrap, jnp.maximum(tex_idx, 0))
    level = jnp.round(jnp.clip(lod, 0.0, n_levels - 1)).astype(jnp.int32)
    if tex.meta is not None:
        mrow = jnp.take(
            tex.meta,
            jnp.maximum(tex_idx, 0) * tex.n_levels + level, axis=0)
        idx, fx, fy = _tap_setup_native(mrow, uv)
    else:
        rel, fx, fy = _tap_setup(tex, uv, level, wrap_mode)
        idx = tex_idx * tex.flat_len + rel  # (H, W) i32

    hp = -(-h // 8) * 8
    wp = -(-w // 128) * 128
    ty, tx = hp // 8, wp // 128
    n_tiles = ty * tx

    def tile_rows(a, fill=0.0):
        a = jnp.pad(a, ((0, hp - h), (0, wp - w)),
                    constant_values=fill)
        return a.reshape(ty, 8, tx, 128).transpose(0, 2, 1, 3).reshape(
            n_tiles, 1024
        )

    act_t = tile_rows(active.astype(jnp.float32))
    idx_t = tile_rows(idx)
    fx_t = tile_rows(fx[..., 0])
    fy_t = tile_rows(fy[..., 0])

    tile_active = act_t.max(axis=1) > 0.0  # (n_tiles,)
    n_act = tile_active.sum().astype(jnp.int32)
    cap = max(1, min(n_tiles, int(-(-n_tiles * cap_frac // 1))))
    assert n_tiles < (1 << 16)

    key = jnp.where(tile_active, 0, 1 << 16) + jnp.arange(
        n_tiles, dtype=jnp.int32
    )
    tids = jnp.sort(key)[:cap] & 0xFFFF

    def sparse():
        cidx = jnp.take(idx_t, tids, axis=0)
        cfx = jnp.take(fx_t, tids, axis=0)
        cfy = jnp.take(fy_t, tids, axis=0)
        rows = jnp.take(tex.alpha_quad, cidx.reshape(-1),
                        axis=0).astype(jnp.float32).reshape(cap, 1024, 4)
        top = rows[..., 0] + (rows[..., 1] - rows[..., 0]) * cfx
        bot = rows[..., 2] + (rows[..., 3] - rows[..., 2]) * cfx
        a = (top + (bot - top) * cfy) / 255.0
        out_t = jnp.zeros((n_tiles, 1024), jnp.float32).at[tids].set(a)
        return out_t

    def dense():
        rows = jnp.take(tex.alpha_quad, idx.reshape(-1),
                        axis=0).astype(jnp.float32).reshape(h, w, 4)
        top = rows[..., 0] + (rows[..., 1] - rows[..., 0]) * fx[..., 0]
        bot = rows[..., 2] + (rows[..., 3] - rows[..., 2]) * fx[..., 0]
        return tile_rows((top + (bot - top) * fy[..., 0]) / 255.0)

    out_t = jax.lax.cond(n_act <= cap, sparse, dense)
    out = out_t.reshape(ty, tx, 8, 128).transpose(0, 2, 1, 3).reshape(
        hp, wp
    )
    return out[:h, :w]


def sample_material_pair(tex: TextureArray, mat_id, uv, lod,
                         trilinear: bool = False):
    """One 32-byte gather per pixel returning BOTH material textures:
    (albedo (H,W,4), metallic-roughness (H,W,4)) raw [0,1] values.

    Requires tex.pair_quad (pack_texture_array with material tables and
    wrap-consistent pairs); caller masks halves whose texture is absent.
    trilinear: DEFAULT_SAMPLER's linear mip filter (samplers.hpp:36-50)
    — doubles the pair gathers; bilinear-at-rounded-mip is the default
    for gather cost (tracked deviation)."""
    n_levels = tex.n_levels if tex.meta is not None else len(tex.sizes)
    pidx = small_lookup(tex.mat_pair, jnp.maximum(mat_id, 0))
    pidx0 = jnp.maximum(pidx, 0)
    lod = jnp.clip(lod, 0.0, n_levels - 1)
    wrap_mode = None
    if tex.pair_meta is None:
        if tex.uniform_wrap is not None:
            wrap_mode = jnp.full(mat_id.shape, tex.uniform_wrap,
                                 jnp.int32)
        else:
            wrap_mode = small_lookup(tex.pair_wrap, pidx0)

    def fetch(level):
        if tex.pair_meta is not None:
            prow = jnp.take(tex.pair_meta, pidx0 * n_levels + level,
                            axis=0)
            idx, fx, fy = _tap_setup_native(prow, uv)
        else:
            rel, fx, fy = _tap_setup(tex, uv, level, wrap_mode)
            idx = pidx0 * tex.flat_len + rel
        rows = jnp.take(tex.pair_quad, idx,
                        axis=0).astype(jnp.float32) / 255.0
        return _bilerp(rows, fx, fy, 0), _bilerp(rows, fx, fy, 16)

    if trilinear:
        l0 = jnp.floor(lod).astype(jnp.int32)
        l1 = jnp.minimum(l0 + 1, n_levels - 1)
        frac = (lod - l0.astype(jnp.float32))[..., None]
        a0, m0 = fetch(l0)
        a1, m1 = fetch(l1)
        return a0 + (a1 - a0) * frac, m0 + (m1 - m0) * frac
    level = jnp.round(lod).astype(jnp.int32)
    return fetch(level)


def sample_texture_array(
    tex: TextureArray, tex_idx, uv, lod=None, quality: str = "bilinear"
):
    """Mipmapped texture sample.

    quality:
      'trilinear' — linear mip filter (DEFAULT_SAMPLER parity, 8 taps)
      'bilinear'  — bilinear at the rounded mip (4 taps; default — XLA
                    gather costs scale with tap count, SURVEY.md §7 hard
                    part 3)
      'nearest'   — single tap at the rounded mip

    Returns (H, W, 4) f32 in [0, 1] — raw stored values (sRGB decode is the
    caller's job, matching the separate SRGB-format semantics).
    """
    n_levels = tex.n_levels if tex.meta is not None else len(tex.sizes)
    # Per-pixel wrap mode when textures differ.
    if tex.uniform_wrap is not None:
        wrap_mode = jnp.full(tex_idx.shape, tex.uniform_wrap, jnp.int32)
    else:
        wrap_mode = small_lookup(tex.wrap, jnp.maximum(tex_idx, 0))
    if lod is None:
        return _sample_level(
            tex, tex_idx, uv, jnp.zeros_like(tex_idx), wrap_mode
        )
    lod = jnp.clip(lod, 0.0, n_levels - 1)
    if quality == "trilinear":
        l0 = jnp.floor(lod).astype(jnp.int32)
        l1 = jnp.minimum(l0 + 1, n_levels - 1)
        frac = (lod - l0.astype(jnp.float32))[..., None]
        c0 = _sample_level(tex, tex_idx, uv, l0, wrap_mode)
        c1 = _sample_level(tex, tex_idx, uv, l1, wrap_mode)
        return c0 + (c1 - c0) * frac
    level = jnp.round(lod).astype(jnp.int32)
    if quality == "nearest":
        return _sample_level_nearest(tex, tex_idx, uv, level, wrap_mode)
    return _sample_level(tex, tex_idx, uv, level, wrap_mode)


def _sample_level_nearest(tex: TextureArray, tex_idx, uv, level, wrap_mode):
    if tex.meta is not None:
        mrow = jnp.take(
            tex.meta,
            jnp.maximum(tex_idx, 0) * tex.n_levels + level, axis=0)
        off, w, h, wm = (mrow[..., 0], mrow[..., 1], mrow[..., 2],
                         mrow[..., 3])
        xi = _wrap_coord(
            jnp.floor(uv[..., 0] * w.astype(jnp.float32)).astype(
                jnp.int32), w, wm)
        yi = _wrap_coord(
            jnp.floor(uv[..., 1] * h.astype(jnp.float32)).astype(
                jnp.int32), h, wm)
        idx = off + yi * w + xi
        return jnp.take(tex.flat, idx, axis=0).astype(jnp.float32) / 255.0
    s = _level_lookup(tex.sizes, level)
    o = _level_lookup(tex.offsets, level)
    sf = s.astype(jnp.float32)
    xi = _wrap_coord(jnp.floor(uv[..., 0] * sf).astype(jnp.int32), s,
                     wrap_mode)
    yi = _wrap_coord(jnp.floor(uv[..., 1] * sf).astype(jnp.int32), s,
                     wrap_mode)
    idx = tex_idx * tex.flat_len + o + yi * s + xi
    return jnp.take(tex.flat, idx, axis=0).astype(jnp.float32) / 255.0
