"""Probe renderer tests: octahedral math, cubemap sampling round trip,
cube2oct depth encoding, probe-grid trace smoke test."""

import numpy as np
import jax.numpy as jnp
import pytest

from vkr.passes import probes as P


class TestOctMath:
    def test_oct_depth_round_trip(self):
        # positive planar distances, near -> 0 / far -> 1
        # (octahedral.glsl:70-77 with z > 0, as the reference passes)
        z = np.linspace(0.06, 79.0, 200).astype(np.float32)
        d = np.asarray(P.encode_oct_depth(jnp.asarray(z)))
        assert d.min() >= 0.0 and d.max() <= 1.0
        assert np.all(np.diff(d) > 0)  # monotone: closer = smaller d
        z2 = np.asarray(P.decode_oct_depth(jnp.asarray(d)))
        assert np.max(np.abs(z2 - z) / np.abs(z)) < 1e-3

    def test_oct_center_is_octant_diagonal(self):
        uv = jnp.asarray([[0.75, 0.5]])  # +x octant area
        c = np.asarray(P.oct_center(uv))[0]
        assert np.allclose(np.linalg.norm(c), 1.0, atol=1e-6)


class TestCubemap:
    def test_sample_cubemap_face_colors(self):
        """Each face painted a constant color: sampling along the face
        axis returns that color."""
        colors = np.zeros((6, 8, 8, 3), np.float32)
        for i in range(6):
            colors[i, :, :, 0] = i
        faces = jnp.asarray(colors)
        dirs = jnp.asarray([
            [1, 0, 0], [-1, 0, 0], [0, 1, 0],
            [0, -1, 0], [0, 0, 1], [0, 0, -1],
        ], jnp.float32)
        out = np.asarray(P.sample_cubemap(faces, dirs))
        np.testing.assert_allclose(out[:, 0], np.arange(6), atol=1e-5)

    def test_cube_to_oct_uniform(self):
        """Uniform cubemap color + distance: oct map is uniform and depth
        decodes to <= the distance."""
        color = jnp.full((6, 16, 16, 3), 0.5)
        dist = jnp.full((6, 16, 16), 5.0)
        oct_color, oct_depth = P.cube_to_oct(color, dist, oct_size=32)
        assert np.allclose(np.asarray(oct_color), 0.5, atol=1e-5)
        z = np.asarray(P.decode_oct_depth(oct_depth))
        # planar depth along octant diagonal <= radial distance
        assert np.all(z <= 5.0 + 1e-3)
        assert np.all(z >= 5.0 / np.sqrt(3) - 1e-2)


class TestProbeRenderer:
    @pytest.fixture(scope="class")
    def scene(self):
        from vkr.passes.gbuffer import upload_scene
        from vkr.scene import colonnade_scene

        return upload_scene(
            colonnade_scene(columns=2, tessellation=6, tex_size=32,
                            foliage=False)
        )

    def test_render_probe(self, scene):
        probe = P.render_probe(scene, (0.0, 2.0, 0.0), cube_size=32,
                               oct_size=32, use_pallas=False)
        assert probe.color.shape == (32, 32, 3)
        c = np.asarray(probe.color)
        d0 = np.asarray(probe.depth_mips[0])
        assert np.isfinite(c).all() and np.isfinite(d0).all()
        # inside the hall: geometry in every direction except windows;
        # some of the oct map must see walls/floor (non-background color)
        assert (c[..., 0] < 50.0).mean() > 0.3
        # depth pyramid is min-bounded
        for a, b in zip(probe.depth_mips[:-1], probe.depth_mips[1:]):
            aa = np.asarray(a)
            h2, w2 = b.shape
            assert np.all(
                np.asarray(b)
                <= aa[: h2 * 2, : w2 * 2]
                .reshape(h2, 2, w2, 2).min(axis=(1, 3)) + 1e-7
            )

    def test_probe_grid_trace_smoke(self, scene):
        from vkr.mathlib import look_at, perspective
        from vkr.mathlib.transforms import inverse_rigid
        from vkr.passes.gbuffer import render_gbuffer

        grid = P.render_probe_grid(
            scene, (-2, 1.5, -2), (2, 1.5, 2), grid_size=2,
            cube_size=16, oct_size=32, use_pallas=False,
        )
        assert grid.colors.shape[0] == 4

        view = look_at((0, 1.2, -3), (0, 1.0, 1), (0, -1, 0))
        proj = perspective(np.radians(60), 1.0, 0.05, 80.0)
        vp = jnp.asarray(proj @ view)
        g = render_gbuffer(scene, vp, vp, jnp.zeros(2), width=32,
                           height=32, use_pallas=False)
        out = P.probe_trace(
            g.depth, g.normal, grid, jnp.asarray(inverse_rigid(view)),
            np.radians(60), 1.0, 0.05, 80.0,
        )
        o = np.asarray(out)
        assert o.shape == (32, 32, 4)
        assert np.isfinite(o).all()


class TestProbeGIFrame:
    @pytest.mark.slow
    def test_probe_gi_feeds_indirect_lighting(self):
        """BASELINE config 5: the full frame graph with enable_probes
        consumes a startup probe grid as indirect reflections — output
        differs from the probeless frame exactly through the reflections
        input, and probe hits are visible in the shaded result."""
        import dataclasses

        from vkr.config import RenderConfig
        from vkr.core.framestate import FrameState
        from vkr.frame import (build_probe_grid, build_ssr_resources,
                                   camera_frame, render_frame)
        from vkr.mathlib import look_at
        from vkr.passes.gbuffer import upload_scene
        from vkr.scene import colonnade_scene

        H = W = 64
        scene_cpu = colonnade_scene(columns=2, tessellation=6, tex_size=32,
                                    foliage=False)
        scene = upload_scene(scene_cpu)
        cfg = RenderConfig(width=W, height=H, enable_ssr=False,
                           enable_gtao=False, enable_taa=False,
                           quantize_formats=False,
                           probes=dataclasses.replace(
                               RenderConfig().probes, grid=2,
                               cube_size=16, oct_size=32))
        cfg_p = dataclasses.replace(cfg, enable_probes=True)
        grid = build_probe_grid(scene_cpu, cfg_p, use_pallas=False)
        res = build_ssr_resources(32)
        view = look_at((0, 1.2, -3), (0, 1.0, 1), (0, -1, 0))
        cam = camera_frame(cfg, view, view, 0)
        st = FrameState.initial(H, W)

        base, _, _ = render_frame(scene, st, cam, res, cfg,
                                  use_pallas=False)
        lit, _, aux = render_frame(scene, FrameState.initial(H, W), cam,
                                   res, cfg_p, probe_grid=grid,
                                   use_pallas=False)
        b = np.asarray(base)
        l = np.asarray(lit)
        assert np.isfinite(l).all()
        diff = np.abs(l - b).max(-1)
        # probe reflections brighten a visible fraction of the frame
        assert (diff > 1e-4).mean() > 0.02


class TestProbeCompose:
    def test_black_but_valid_ssr_survives(self):
        """compose_probe_reflections keys on TRACE validity (rays w
        channel), not on blurred color: a valid-but-black SSR pixel must
        NOT be overwritten by probe GI (VERDICT r4)."""
        import jax.numpy as jnp
        import numpy as np

        from vkr.frame import compose_probe_reflections

        ssr = jnp.zeros((2, 2, 3), jnp.float32)  # black everywhere
        rays = jnp.zeros((2, 2, 4), jnp.float32)
        rays = rays.at[0, 0, 3].set(0.5)   # valid hit (src depth < 1)
        rays = rays.at[..., 3].set(
            jnp.where(jnp.arange(2)[:, None] + jnp.arange(2)[None, :] == 0,
                      0.5, 1.0))           # only (0,0) valid
        probe = jnp.ones((2, 2, 3), jnp.float32)
        out = np.asarray(compose_probe_reflections(ssr, rays, probe))
        assert np.all(out[0, 0] == 0.0)    # valid black SSR kept
        assert np.all(out[0, 1] == 1.0)    # invalid pixels probe-filled
        assert np.all(out[1, 0] == 1.0)
