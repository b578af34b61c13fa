"""Pass-level tests: hi-Z downsample, GTAO (dense vs exact), SSR LUTs and
trace sanity, TAA, SSAO, screen-trace, util passes (SURVEY.md §4 rebuild
implication: pure-function pass tests, golden properties)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from vkr.mathlib import encode_normal, look_at, perspective
from vkr.mathlib.projection import encode_depth
from vkr.mathlib.transforms import inverse_rigid, normal_matrix


@pytest.fixture(scope="module")
def synthetic_scene():
    """Analytic depth/normal for a floor + wall corner (raytraced, no
    rasterizer dependency)."""
    H = W = 64
    fovy, aspect, zn, zf = np.radians(60), 1.0, 0.05, 80.0
    # Close-range geometry: reciprocal-depth precision at z ~ zfar makes
    # the SSR depth tolerances reject everything far away (by design —
    # the reference has the same linearized-depth tolerances).
    view = look_at((0, 1.2, -1.5), (0, 0.5, 1.0), (0, -1, 0))
    inv = np.linalg.inv(view)
    ys, xs = np.meshgrid(
        (np.arange(H) + 0.5) / H, (np.arange(W) + 0.5) / W, indexing="ij"
    )
    tg = np.tan(fovy / 2)
    dir_cam = np.stack(
        [-(2 * xs - 1) * tg * aspect, -(2 * ys - 1) * tg,
         -np.ones_like(xs)], -1,
    )
    dir_world = dir_cam @ inv[:3, :3].T
    org = inv[:3, 3]
    t_floor = np.where(dir_world[..., 1] < 0,
                       -org[1] / dir_world[..., 1], 1e9)
    t_wall = np.where(dir_world[..., 2] > 0,
                      (2.5 - org[2]) / dir_world[..., 2], 1e9)
    y_wall = org[1] + t_wall * dir_world[..., 1]
    t_wall = np.where((y_wall >= 0) & (y_wall <= 2.0), t_wall, 1e9)
    t = np.minimum(t_floor, t_wall)
    hit_wall = t_wall < t_floor
    depth = np.clip(
        np.asarray(encode_depth(jnp.asarray(-t), zn, zf)), 0, 1
    ).astype(np.float32)
    nrm = np.where(hit_wall[..., None], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0])
    noct = np.asarray(encode_normal(jnp.asarray(nrm)))
    vel = np.zeros((H, W, 2), np.float32)
    return dict(depth=jnp.asarray(depth), normal=jnp.asarray(noct),
                velocity=jnp.asarray(vel), view=view, fovy=fovy,
                aspect=aspect, znear=zn, zfar=zf)


class TestDownsample:
    def test_hiz_min_property(self, synthetic_scene):
        from vkr.passes.downsample import build_hiz

        s = synthetic_scene
        hiz = build_hiz(s["depth"], s["normal"], s["velocity"])
        d = np.asarray(s["depth"])
        assert np.all(
            np.asarray(hiz.mips[0])
            <= d.reshape(32, 2, 32, 2).min(axis=(1, 3)) + 1e-7
        )
        # every mip min-bounds the previous
        for a, b in zip(hiz.mips[:-1], hiz.mips[1:]):
            aa = np.asarray(a)
            h2, w2 = b.shape
            assert np.all(
                np.asarray(b)
                <= aa[: h2 * 2, : w2 * 2]
                .reshape(h2, 2, w2, 2).min(axis=(1, 3)) + 1e-7
            )

    def test_normal_follows_min_depth(self):
        from vkr.passes.downsample import downsample_gbuffer

        depth = jnp.asarray([[0.5, 0.2], [0.9, 0.7]], jnp.float32)
        normal = jnp.arange(8, dtype=jnp.float32).reshape(2, 2, 2)
        vel = jnp.zeros((2, 2, 2))
        dmin, n_half, _ = downsample_gbuffer(depth, normal, vel)
        assert abs(float(dmin[0, 0]) - 0.2) < 1e-6
        # min at (dx=1, dy=0) -> normal[0, 1]
        np.testing.assert_allclose(np.asarray(n_half[0, 0]),
                                   np.asarray(normal[0, 1]))


class TestGTAO:
    def _params(self, s):
        from vkr.passes.gtao import GTAOParams

        return GTAOParams(
            normal_mat=jnp.asarray(normal_matrix(s["view"])),
            fovy=s["fovy"], aspect=s["aspect"],
            znear=s["znear"], zfar=s["zfar"],
        )

    def test_flat_plane_unoccluded(self):
        from vkr.passes.gtao import (GTAOParams, gtao_filter,
                                         gtao_main_dense, gtao_main_exact)

        H = W = 64
        depth = jnp.full((H, W),
                         float(encode_depth(jnp.asarray(-5.0), 0.05, 80.0)))
        noct = encode_normal(
            jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), (H, W, 3))
        )
        p = GTAOParams(normal_mat=jnp.eye(4), fovy=np.radians(60),
                       aspect=1.0, znear=0.05, zfar=80.0)
        for fn in (gtao_main_exact, gtao_main_dense):
            ao = fn(depth, noct, p, jnp.asarray(0.0))
            filt = np.asarray(gtao_filter(depth, ao, 0.05, 80.0))[8:-8, 8:-8]
            assert abs(filt.mean() - 1.0) < 0.02
            assert filt.std() < 0.02

    def test_window_matches_exact(self, synthetic_scene):
        """The production main ("gtao_main") IS the exact port with the
        reference's own fractional-step sampling (16 bilinear taps, no
        window clamp): the registry routes it there and the jitted pass
        matches the eager oracle to float rounding."""
        import jax

        from vkr.core import registry
        from vkr.passes.gtao import gtao_main_exact

        assert registry.get("gtao_main") is gtao_main_exact
        s = synthetic_scene
        p = self._params(s)
        base = jnp.asarray(0.37)
        e = np.asarray(gtao_main_exact(s["depth"], s["normal"], p, base))
        j = np.asarray(jax.jit(
            lambda d, n: registry.get("gtao_main")(d, n, p, base))(
                s["depth"], s["normal"]))
        # jit fuses the horizon march differently from eager execution:
        # float-rounding-level deviations only (the bars of the former
        # window-kernel comparison)
        assert np.abs(e - j).max() < 1e-3, np.abs(e - j).max()
        assert np.abs(e - j).mean() < 5e-5

    def test_dense_matches_exact_statistically(self, synthetic_scene):
        from vkr.passes.gtao import (gtao_filter, gtao_main_dense,
                                         gtao_main_exact)

        s = synthetic_scene
        p = self._params(s)
        base = jnp.asarray(0.37)
        e = gtao_filter(s["depth"], gtao_main_exact(
            s["depth"], s["normal"], p, base), s["znear"], s["zfar"])
        d = gtao_filter(s["depth"], gtao_main_dense(
            s["depth"], s["normal"], p, base), s["znear"], s["zfar"])
        e, d = np.asarray(e), np.asarray(d)
        corr = np.corrcoef(e.ravel(), d.ravel())[0, 1]
        assert corr > 0.9, corr
        assert np.abs(e - d).mean() < 0.06

    def test_accumulate_static_camera_converges(self, synthetic_scene):
        from vkr.passes.gtao import GTAOAccumParams, gtao_accumulate

        s = synthetic_scene
        inv = inverse_rigid(s["view"])
        proj = perspective(s["fovy"], s["aspect"], s["znear"], s["zfar"])
        ap = GTAOAccumParams(
            inverse_camera=jnp.asarray(inv),
            prev_inverse_camera=jnp.asarray(inv),
            mvp=jnp.asarray(proj @ s["view"]),
            fovy=s["fovy"], aspect=s["aspect"],
            znear=s["znear"], zfar=s["zfar"],
        )
        ao = jnp.full(s["depth"].shape, 0.5)
        hist = jnp.stack([jnp.full(s["depth"].shape, 0.9),
                          jnp.full(s["depth"].shape, 10 / 255.0)], -1)
        out = gtao_accumulate(
            s["depth"], s["depth"], ao, s["velocity"], hist, ap,
            jnp.asarray(False),
        )
        out = np.asarray(out)
        # running mean of 10 samples at 0.9 plus one 0.5: ~0.864
        inner = out[8:-8, 8:-8]
        assert abs(inner[..., 0].mean() - (0.9 * 10 + 0.5) / 11) < 0.01
        assert abs(inner[..., 1].mean() - 11 / 255.0) < 1e-3

        # clear_history drops accumulation
        out2 = np.asarray(
            gtao_accumulate(s["depth"], s["depth"], ao, s["velocity"],
                            hist, ap, jnp.asarray(True))
        )
        assert np.allclose(out2[..., 0], 0.5, atol=1e-5)


class TestSSRLuts:
    def test_brdf_lut_bounds(self):
        from vkr.passes.ssr import preintegrate_brdf

        lut = np.asarray(preintegrate_brdf(32, num_samples=32))
        assert lut.shape == (32, 32, 2)
        assert np.all(lut >= 0) and np.all(lut[..., 0] <= 1.5)
        # smooth + head-on: A ~ 1, B ~ 0
        assert lut[-1, 2, 0] > 0.9
        assert lut[-1, 2, 1] < 0.1

    def test_pdf_lut_positive(self):
        from vkr.passes.ssr import preintegrate_pdf

        lut = np.asarray(preintegrate_pdf(32, steps=200))
        assert lut.shape == (32, 32)
        assert np.all(lut >= 0)


class TestSSRTrace:
    def test_mirror_floor_hits_wall(self):
        """Rasterize a floor + wall with the real pipeline; near-mirror
        floor rays must find valid hits that land on wall pixels."""
        from vkr.frame import build_ssr_resources
        from vkr.passes.downsample import build_hiz
        from vkr.passes.ssr import SSRParams, pack_pyramid, ssr_trace
        from vkr.raster import rasterize

        W = H = 64
        view = look_at((0, 1.0, -2.0), (0, 0.8, 1.0), (0, -1, 0))
        proj = perspective(np.radians(60), 1.0, 0.05, 80.0)
        vp = proj @ view
        world = np.array(
            [[-4, 0, -4, 1], [4, 0, -4, 1], [4, 0, 3, 1], [-4, 0, 3, 1],
             [-4, 0, 3, 1], [4, 0, 3, 1], [4, 3, 3, 1], [-4, 3, 3, 1]],
            np.float32,
        )
        clip = jnp.asarray(world @ vp.T)
        idx = jnp.asarray(
            [[0, 1, 2], [0, 2, 3], [4, 5, 6], [4, 6, 7]], jnp.int32
        )
        vis = rasterize(clip, idx, width=W, height=H, use_pallas=False)
        # per-pixel normals: floor (0,1,0) / wall (0,0,-1)
        src = np.asarray(vis.src)[np.maximum(np.asarray(vis.tri_id), 0)]
        is_wall = src >= 2
        nrm = np.where(is_wall[..., None], [0.0, 0.0, -1.0],
                       [0.0, 1.0, 0.0])
        noct = encode_normal(jnp.asarray(nrm))

        hiz = build_hiz(vis.depth, noct,
                        jnp.zeros((H, W, 2), jnp.float32))
        res = build_ssr_resources(32)
        p = SSRParams(
            normal_mat=jnp.asarray(normal_matrix(view)),
            fovy=np.radians(60), aspect=1.0, znear=0.05, zfar=80.0,
            max_roughness=0.02,  # near-mirror
        )
        material = jnp.zeros((H, W, 4), jnp.float32)
        rays, occ = ssr_trace(
            pack_pyramid(hiz.mips), hiz.normal_half, material,
            res.pdf_lut, p, jnp.asarray(0, jnp.int32), res.halton,
            max_iterations=64,
        )
        r = np.asarray(rays)
        assert np.isfinite(r).all()
        valid = r[..., 3] != 1.0
        assert valid.mean() > 0.02, valid.mean()
        # most valid hits stay in screen bounds (off-screen escapes can
        # pass the reference's clamped-sampler depth checks too)
        in_bounds = (
            (r[..., 0] >= -0.01) & (r[..., 0] <= 1.01)
            & (r[..., 1] >= -0.01) & (r[..., 1] <= 1.01)
        )
        assert (in_bounds[valid]).mean() > 0.8
        # in-bounds hits should predominantly land on the wall
        ok = valid & in_bounds
        wall_half = np.asarray(is_wall[::2, ::2])
        hit_rows = (r[..., 1][ok] * 32).astype(int).clip(0, 31)
        hit_cols = (r[..., 0][ok] * 32).astype(int).clip(0, 31)
        frac_on_wall = wall_half[hit_rows, hit_cols].mean()
        assert frac_on_wall > 0.5, frac_on_wall


class TestTAA:
    def test_static_scene_converges_to_current(self, synthetic_scene):
        from vkr.passes.taa import TAAParams, taa_resolve

        s = synthetic_scene
        inv = jnp.asarray(inverse_rigid(s["view"]))
        p = TAAParams(inverse_camera=inv, prev_inverse_camera=inv,
                      fovy=s["fovy"], aspect=s["aspect"],
                      znear=s["znear"], zfar=s["zfar"])
        cur = jnp.full((*s["depth"].shape, 3), 0.8)
        hist = jnp.full((*s["depth"].shape, 3), 0.8)
        vel = jnp.zeros((*s["depth"].shape, 2))
        out = taa_resolve(hist, s["depth"], s["depth"], vel, cur, p)
        np.testing.assert_allclose(np.asarray(out), 0.8, atol=1e-6)

    def test_neighborhood_clamp_rejects_ghost(self, synthetic_scene):
        from vkr.passes.taa import TAAParams, taa_resolve

        s = synthetic_scene
        inv = jnp.asarray(inverse_rigid(s["view"]))
        p = TAAParams(inverse_camera=inv, prev_inverse_camera=inv,
                      fovy=s["fovy"], aspect=s["aspect"],
                      znear=s["znear"], zfar=s["zfar"])
        h, w = s["depth"].shape
        cur = jnp.full((h, w, 3), 0.2)
        # history has a bright ghost pixel; clamp must bound it by the
        # neighborhood
        hist = jnp.full((h, w, 3), 0.2).at[32, 32].set(5.0)
        vel = jnp.zeros((h, w, 2))
        out = np.asarray(
            taa_resolve(hist, s["depth"], s["depth"], vel, cur, p)
        )
        assert out[32, 32].max() <= 0.25


class TestSSAO:
    def test_flat_wall_unoccluded(self):
        from vkr.passes.ssao import SSAOParams, ssao

        H = W = 64
        proj = perspective(np.radians(60), 1.0, 0.05, 80.0)
        depth = jnp.full(
            (H, W), float(encode_depth(jnp.asarray(-5.0), 0.05, 80.0))
        )
        p = SSAOParams(projection=jnp.asarray(proj), fovy=np.radians(60),
                       aspect=1.0, znear=0.05, zfar=80.0)
        occ = np.asarray(ssao(depth, p))[8:-8, 8:-8]
        # half the sphere samples fall behind the wall
        assert 0.3 < occ.mean() < 0.7


class TestScreenTrace:
    def test_runs_and_bounded(self, synthetic_scene):
        from vkr.passes.screen_trace import (ScreenTraceParams,
                                                 screen_trace,
                                                 screen_trace_filter)

        s = synthetic_scene
        p = ScreenTraceParams(
            normal_mat=jnp.asarray(normal_matrix(s["view"])),
            fovy=s["fovy"], aspect=s["aspect"], znear=s["znear"],
            zfar=s["zfar"],
        )
        color = jnp.full((*s["depth"].shape, 3), 0.5)
        out = screen_trace(s["depth"], s["normal"], color, p)
        o = np.asarray(out)
        assert np.isfinite(o).all()
        assert np.all(o[..., :3] >= 0)
        f = np.asarray(
            screen_trace_filter(s["depth"], out, s["znear"], s["zfar"])
        )
        assert np.isfinite(f).all()


class TestUtilPasses:
    def test_perlin_range_and_det(self):
        from vkr.passes.util_passes import gen_perlin_noise2d

        a = np.asarray(gen_perlin_noise2d(32, 32))
        b = np.asarray(gen_perlin_noise2d(32, 32))
        np.testing.assert_array_equal(a, b)
        assert a.std() > 0.01 and np.abs(a).max() < 4.0

    def test_mipmaps(self):
        from vkr.passes.util_passes import gen_mipmaps

        img = jnp.ones((16, 8, 3))
        mips = gen_mipmaps(img)
        assert [m.shape[:2] for m in mips] == [
            (16, 8), (8, 4), (4, 2), (2, 1)
        ]
        assert np.allclose(np.asarray(mips[-1]), 1.0)

    def test_backbuffer_channel_select(self):
        from vkr.passes.util_passes import DrawTex, backbuffer_draw

        tex = jnp.stack(
            [jnp.full((8, 8), 0.1), jnp.full((8, 8), 0.5),
             jnp.full((8, 8), 0.9)], -1,
        )
        r = np.asarray(backbuffer_draw(tex, 8, 8, DrawTex.ShowG))
        assert np.allclose(r, 0.5, atol=1e-6)

    def test_blit_resizes(self):
        from vkr.passes.util_passes import blit_image

        img = jnp.arange(64, dtype=jnp.float32).reshape(8, 8)
        out = blit_image(img, 4, 4)
        assert out.shape == (4, 4)


class TestShadowPath:
    def test_occluder_shadows_floor(self):
        """shadows.py: a quad floating above a floor, light from
        straight overhead — floor texels under the quad are occluded,
        the rest are lit (render_shadow / shaders/shadows/)."""
        import numpy as np
        import jax.numpy as jnp

        from vkr.mathlib import look_at, perspective
        from vkr.passes.gbuffer import upload_scene
        from vkr.passes.shadows import (render_shadow_map,
                                            sample_shadow_factor)
        from vkr.scene.procedural import two_masked_quads_scene

        # reuse the stacked-quads scene: backdrop at z=2 is the "floor",
        # the z=-1 quad the occluder; light looks down +z
        scene = upload_scene(two_masked_quads_scene(tex_size=16))
        light_view = look_at((0.0, 0.0, -8.0), (0.0, 0.0, 1.0),
                             (0, -1, 0))
        light_proj = perspective(np.radians(45), 1.0, 0.5, 40.0)
        mvp = jnp.asarray(light_proj @ light_view)
        sm = render_shadow_map(scene, mvp, size=128, use_pallas=False)
        assert float(sm.min()) < 1.0  # something rendered

        # world points on the backdrop plane: one behind the occluder
        # quad (|x|,|y| < 2), one outside it (on the 4-wide backdrop)
        pts = jnp.asarray([[[0.0, 0.0, 2.0], [3.5, 3.5, 2.0]]])
        f = np.asarray(sample_shadow_factor(pts, mvp, sm))
        assert f[0, 0] == 0.0  # occluded by the front quads
        assert f[0, 1] == 1.0  # direct line to the light

    def test_draw_directions_matches_shader_hash(self):
        """rotations/rot.comp parity: stripes constant along the chosen
        direction."""
        import numpy as np
        import jax.numpy as jnp

        from vkr.passes.util_passes import draw_directions

        img = np.asarray(draw_directions(32, 32, jnp.asarray(0.0)))
        assert img.shape == (32, 32) and (img >= 0).all() and (img < 1).all()
        # angle 0: c = -x (cos 0 / sin 0 are exact) -> constant along
        # y; the hash amplifies float eps at other angles, faithfully
        # to the GLSL
        assert np.allclose(img, img[0][None, :])
        assert img[0].std() > 0.1  # hashed stripes, not constant


def test_halton_base_index_band_rows_and_formula():
    """The SSR trace's per-pixel halton base index: trace.comp rand(uv)
    scaled to the sequence size, the same table in every program, and a
    band's rows are the full table's rows."""
    from vkr.passes.ssr import HALTON_SEQ_SIZE, halton_base_index

    h, w, bh, row0 = 30, 44, 10, 12
    full = np.asarray(halton_base_index(h, w))
    assert full.shape == (h, w) and full.max() < HALTON_SEQ_SIZE
    band = np.asarray(jax.jit(lambda r: halton_base_index(h, w, r, bh))(
        jnp.int32(row0)))
    np.testing.assert_array_equal(band, full[row0:row0 + bh])
    # the reference hash at a few pixels, evaluated in float64
    for y, x in ((0, 0), (7, 31), (29, 43)):
        u = np.float32((x + 0.5) / w)
        v = np.float32((y + 0.5) / h)
        dot = np.float32(u * np.float32(12.9898)) + \
            np.float32(v * np.float32(78.233))
        s = np.sin(np.float64(dot)) * 43758.5453
        rand = np.float32(s - np.floor(s))
        assert full[y, x] == min(int(rand * np.float32(HALTON_SEQ_SIZE)),
                                 HALTON_SEQ_SIZE - 1)
