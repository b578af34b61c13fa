"""Native-size texture packing (raster/texture.py native mode) — the
per-texture resolution/aspect parity path (scene.cpp:104-161)."""

import numpy as np
import jax.numpy as jnp

from vkr.raster.texture import (pack_texture_array_native,
                                    sample_material_pair,
                                    sample_texture_array)
from vkr.scene.gltf import WRAP_CLAMP, WRAP_REPEAT


def _mk(h, w, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 255, (h, w, 4), dtype=np.uint8)


def _bilinear_ref(img, uv, wrap):
    """Plain numpy bilinear at level 0 with the sampler's conventions."""
    h, w = img.shape[:2]
    out = np.zeros(uv.shape[:-1] + (4,), np.float32)
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0 = np.floor(x).astype(int)
    y0 = np.floor(y).astype(int)
    fx = x - x0
    fy = y - y0
    if wrap == WRAP_CLAMP:
        fx = np.where(x0 < 0, 0.0, fx)
        fy = np.where(y0 < 0, 0.0, fy)

    def wc(i, n):
        return i % n if wrap == WRAP_REPEAT else np.clip(i, 0, n - 1)

    for dy in (0, 1):
        for dx in (0, 1):
            t = img[wc(y0 + dy, h), wc(x0 + dx, w)].astype(np.float32)
            wgt = (fx if dx else 1 - fx) * (fy if dy else 1 - fy)
            out += wgt[..., None] * t
    return out / 255.0


class TestNativePack:
    def test_mixed_sizes_level0_bilinear(self):
        imgs = [_mk(64, 32, 0), _mk(16, 16, 1), _mk(8, 32, 2)]
        wrap = np.asarray([WRAP_REPEAT, WRAP_CLAMP, WRAP_REPEAT],
                          np.int32)
        tex = pack_texture_array_native(imgs, wrap)
        assert tex.meta is not None and tex.n_levels >= 7

        rng = np.random.default_rng(3)
        uv = rng.uniform(0.05, 0.95, (4, 8, 2)).astype(np.float32)
        for t in range(3):
            tex_idx = jnp.full((4, 8), t, jnp.int32)
            got = np.asarray(sample_texture_array(
                tex, tex_idx, jnp.asarray(uv),
                lod=jnp.zeros((4, 8)), quality="bilinear"))
            want = _bilinear_ref(imgs[t], uv, int(wrap[t]))
            np.testing.assert_allclose(got, want, atol=2e-3), t

    def test_aspect_preserved_vs_uniform(self):
        """A 2:1 texture must sample WITHOUT aspect distortion: a
        vertical stripe pattern sampled along u keeps its frequency."""
        img = np.zeros((8, 64, 4), np.uint8)
        img[:, ::2] = 255  # 32 vertical stripes
        tex = pack_texture_array_native([img],
                                        np.asarray([WRAP_REPEAT]))
        u = (np.arange(64, dtype=np.float32) + 0.5) / 64.0
        uv = np.stack([u, np.full_like(u, 0.5)], -1)[None]
        got = np.asarray(sample_texture_array(
            tex, jnp.zeros((1, 64), jnp.int32), jnp.asarray(uv),
            lod=jnp.zeros((1, 64))))[0, :, 0]
        # exact texel centers -> exact stripe values
        assert np.abs(got[::2] - 1.0).max() < 1e-5
        assert np.abs(got[1::2]).max() < 1e-5

    def test_pair_path_mixed_sizes(self):
        """Dim-matched albedo+MR pairs zip; mismatched sets fall back
        (all-or-nothing like the uniform path)."""
        imgs = [_mk(32, 32, 0), _mk(32, 32, 1)]
        wrap = np.asarray([WRAP_REPEAT, WRAP_REPEAT], np.int32)
        tex = pack_texture_array_native(
            imgs, wrap, mat_albedo_tex=np.asarray([0], np.int32),
            mat_mr_tex=np.asarray([1], np.int32))
        assert tex.pair_quad is not None
        uv = jnp.asarray(
            np.random.default_rng(5).uniform(0.1, 0.9, (2, 4, 2)),
            jnp.float32)
        alb, mr = sample_material_pair(
            tex, jnp.zeros((2, 4), jnp.int32), uv, jnp.zeros((2, 4)))
        ref_a = _bilinear_ref(imgs[0], np.asarray(uv), WRAP_REPEAT)
        ref_m = _bilinear_ref(imgs[1], np.asarray(uv), WRAP_REPEAT)
        np.testing.assert_allclose(np.asarray(alb), ref_a, atol=2e-3)
        np.testing.assert_allclose(np.asarray(mr), ref_m, atol=2e-3)

        # mismatched dims -> no pair table, full quad fallback present
        imgs2 = [_mk(32, 32, 0), _mk(16, 16, 1)]
        tex2 = pack_texture_array_native(
            imgs2, wrap, mat_albedo_tex=np.asarray([0], np.int32),
            mat_mr_tex=np.asarray([1], np.int32))
        assert tex2.pair_quad is None
        assert tex2.flat_quad is not None

    def test_trilinear_native(self):
        img = _mk(32, 16, 9)
        tex = pack_texture_array_native([img],
                                        np.asarray([WRAP_CLAMP]))
        uv = jnp.asarray([[[0.5, 0.5]]], jnp.float32)
        c0 = np.asarray(sample_texture_array(
            tex, jnp.zeros((1, 1), jnp.int32), uv,
            lod=jnp.zeros((1, 1)), quality="trilinear"))
        c1 = np.asarray(sample_texture_array(
            tex, jnp.zeros((1, 1), jnp.int32), uv,
            lod=jnp.full((1, 1), float(tex.n_levels - 1)),
            quality="trilinear"))
        assert np.isfinite(c0).all() and np.isfinite(c1).all()
        # the deepest level is the global mean of the texture
        np.testing.assert_allclose(
            c1[0, 0], img.reshape(-1, 4).mean(0) / 255.0, atol=0.02)


class TestNativeSceneLoad:
    def test_gltf_native_load_renders(self):
        import jax

        from vkr.scene.scene import compile_scene
        from vkr.scene import gltf as G
        from vkr.passes.gbuffer import render_gbuffer, upload_scene
        from vkr.mathlib import look_at, perspective

        path = "/root/reference/assets/gltf/suzanne/Suzanne.gltf"
        sc = compile_scene(G.load_gltf(path), tex_size=256,
                           native_sizes=True)
        assert sc.tex_images is not None
        scene = upload_scene(sc)
        assert scene.tex.meta is not None
        view = look_at((0, 0.5, -3.0), (0, 0, 0), (0, -1, 0))
        proj = perspective(np.radians(60), 1.0, 0.05, 80.0)
        import jax.numpy as jnp
        mvp = jnp.asarray(proj @ view)
        gb = render_gbuffer(scene, mvp, mvp, (0.0, 0.0),
                            width=128, height=128, use_pallas=False)
        cov = float((np.asarray(gb.depth) < 1.0).mean())
        assert cov > 0.1
        assert np.isfinite(np.asarray(gb.albedo)).all()
        # non-background pixels carry sampled texture, not the default
        m = np.asarray(gb.depth) < 1.0
        assert np.asarray(gb.albedo)[m][..., :3].std() > 1e-3
