"""Aux subsystem tests: checkpoint/resume, sample heatmap, GTAO variants
(normal-space, MIS), simple SSR, DAG tooling, config registry."""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from vkr.mathlib import encode_normal, look_at, perspective
from vkr.mathlib.projection import encode_depth
from vkr.mathlib.transforms import normal_matrix


class TestCheckpoint:
    def test_save_load_round_trip(self, tmp_path):
        from vkr.core.checkpoint import load_state, save_state
        from vkr.core.framestate import FrameState

        st = FrameState.initial(32, 64)
        st = st.replace(frame_index=jnp.asarray(7, jnp.int32))
        p = save_state(st, str(tmp_path / "state.npz"))
        st2 = load_state(p)
        for name in FrameState.FIELDS:
            np.testing.assert_array_equal(
                np.asarray(getattr(st, name)),
                np.asarray(getattr(st2, name)), err_msg=name,
            )


class TestSamplesMarker:
    def test_heatmap_counts(self):
        from vkr.passes.trace_samples import SamplesMarker

        m = SamplesMarker(16, 16, window=(0.0, 0.0, 1.0, 1.0))
        src = jnp.full((4, 2), 0.5)
        fetch = jnp.asarray([[0.5, 0.5]] * 4)
        m.trace(src, fetch)
        hm = np.asarray(m.heatmap)
        assert hm[8, 8] == 4 and hm.sum() == 4
        m.clear()
        assert np.asarray(m.heatmap).sum() == 0

    def test_window_filters_sources(self):
        from vkr.passes.trace_samples import SamplesMarker

        m = SamplesMarker(16, 16, window=(0.4, 0.4, 0.6, 0.6))
        src = jnp.asarray([[0.5, 0.5], [0.9, 0.9]])
        fetch = jnp.asarray([[0.1, 0.1], [0.2, 0.2]])
        m.trace(src, fetch)
        assert np.asarray(m.heatmap).sum() == 1


class TestGTAOVariants:
    def _flat_inputs(self):
        H = W = 48
        depth = jnp.full(
            (H, W), float(encode_depth(jnp.asarray(-5.0), 0.05, 80.0))
        )
        noct = encode_normal(
            jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), (H, W, 3))
        )
        from vkr.passes.gtao import GTAOParams

        p = GTAOParams(normal_mat=jnp.eye(4), fovy=np.radians(60),
                       aspect=1.0, znear=0.05, zfar=80.0)
        return depth, noct, p

    def test_normal_space_flat_wall(self):
        from vkr.passes.gtao import gtao_filter, gtao_normal_space

        depth, noct, p = self._flat_inputs()
        ao = gtao_normal_space(depth, noct, p, jnp.asarray(0.0))
        filt = np.asarray(
            gtao_filter(depth, ao, 0.05, 80.0)
        )[8:-8, 8:-8]
        # (1 - h^2) unoccluded ~ 1
        assert abs(filt.mean() - 1.0) < 0.05

    def test_mis_mode_runs(self):
        from vkr.frame import build_ssr_resources
        from vkr.passes.gtao import gtao_main_mis

        depth, noct, p = self._flat_inputs()
        res = build_ssr_resources(32)
        material = jnp.full((*depth.shape, 4), 0.5)
        ssr_occ = jnp.stack(
            [jnp.full(depth.shape, 0.3),
             jnp.full(depth.shape, 1.0 / (2 * np.pi))], -1,
        )
        out = np.asarray(
            gtao_main_mis(depth, noct, material, res.pdf_lut, ssr_occ, p,
                          jnp.asarray(0.0))
        )
        assert np.isfinite(out).all()
        # the jitted pass (as the frame runs it) matches eager execution
        import jax

        out_j = np.asarray(jax.jit(
            lambda d: gtao_main_mis(d, noct, material, res.pdf_lut,
                                    ssr_occ, p, jnp.asarray(0.0)))(depth))
        assert np.abs(out_j - out).max() < 1e-4
        # reflections_only mode returns the ratio
        ratio = np.asarray(
            gtao_main_mis(depth, noct, material, res.pdf_lut, ssr_occ, p,
                          jnp.asarray(0.0), reflections_only=True)
        )
        assert np.allclose(ratio[8:-8, 8:-8],
                           0.3 / (1.0 / (2 * np.pi)), atol=1e-3)


class TestTuning:
    def test_traced_sliders_no_retrace(self):
        """frame.Tuning scalars are traced push-constant analogs: two
        slider values reuse ONE compiled executable (the reference's
        ImGui sliders update push constants without a pipeline rebuild,
        gtao.cpp:533)."""
        import jax

        from vkr.config import RenderConfig
        from vkr.frame import Tuning, build_ssr_resources
        from vkr.passes.gtao import gtao_main_mis

        cfg = RenderConfig()
        t = Tuning.of(cfg)
        assert t.weight_ratio == cfg.gtao.weight_ratio
        assert t.shade_max_roughness == cfg.shading.max_roughness

        tv = TestGTAOVariants()
        depth, noct, p = tv._flat_inputs()
        res = build_ssr_resources(32)
        material = jnp.full((*depth.shape, 4), 0.5)
        ssr_occ = jnp.stack(
            [jnp.full(depth.shape, 0.3),
             jnp.full(depth.shape, 1.0 / (2 * np.pi))], -1,
        )

        @jax.jit
        def f(w):
            return gtao_main_mis(depth, noct, material, res.pdf_lut,
                                 ssr_occ, p, jnp.asarray(0.0),
                                 weight_ratio=w)

        out1 = np.asarray(f(jnp.float32(1.0)))
        out5 = np.asarray(f(jnp.float32(5.0)))
        assert f._cache_size() == 1  # no re-jit on slider move
        assert np.isfinite(out1).all() and np.isfinite(out5).all()
        assert np.abs(out1 - out5).max() > 1e-4  # the knob is live


class TestSimpleSSR:
    def test_mirror_floor(self):
        from vkr.passes.downsample import build_hiz
        from vkr.passes.simple_ssr import simple_ssr
        from vkr.passes.ssr import SSRParams, pack_pyramid
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
        src = np.asarray(vis.src)[np.maximum(np.asarray(vis.tri_id), 0)]
        nrm = np.where((src >= 2)[..., None], [0.0, 0.0, -1.0],
                       [0.0, 1.0, 0.0])
        noct = encode_normal(jnp.asarray(nrm))
        hiz = build_hiz(vis.depth, noct, jnp.zeros((H, W, 2)))
        p = SSRParams(normal_mat=jnp.asarray(normal_matrix(view)),
                      fovy=np.radians(60), aspect=1.0, znear=0.05,
                      zfar=80.0)
        frame = jnp.full((H // 2, W // 2, 3), 0.7)
        out = np.asarray(
            simple_ssr(pack_pyramid(hiz.mips), hiz.normal_half, frame, p)
        )
        assert np.isfinite(out).all()
        assert (out[..., 3] > 0).mean() > 0.01  # some mirror hits


class TestRegistryAndGraph:
    def test_registry_resolves_live_passes(self):
        from vkr.core import registry

        # The production passes registered themselves on import (frame.py
        # builds the graph through these names).
        import vkr.frame  # noqa: F401
        from vkr.passes import gtao, shading, taa

        assert registry.get("gtao_main") is gtao.gtao_main_exact
        assert registry.get("defered_shading") is shading.deferred_shading
        assert registry.get("taa_resolve") is taa.taa_resolve
        for name in ("gbuf_opaque_taa", "sssr_trace", "sssr_filter",
                     "sssr_blur", "gtao_filter", "gtao_accumulate",
                     "downsample_hiz", "cube2oct", "trace_probe"):
            assert name in registry.names(), name

    def test_hot_reload_takes_effect_without_restart(self, tmp_path):
        """The reference's key-R shader hot reload (main.cpp:319-321):
        editing a registered pass module + registry.reload() changes the
        output of an already-jitted frame-level function."""
        import sys

        import jax

        from vkr.core import registry

        mod_path = tmp_path / "hot_pass_mod.py"
        mod_path.write_text(
            "from vkr.core.registry import register\n"
            "@register('hot_test_pass')\n"
            "def run(x):\n"
            "    return x * 2\n"
        )
        sys.path.insert(0, str(tmp_path))
        try:
            import hot_pass_mod  # noqa: F401

            frame = registry.track_jit(
                jax.jit(lambda x: registry.get("hot_test_pass")(x))
            )
            x = jnp.ones((8,))
            assert np.asarray(frame(x))[0] == 2.0
            mod_path.write_text(
                "from vkr.core.registry import register\n"
                "@register('hot_test_pass')\n"
                "def run(x):\n"
                "    return x * 3\n"
            )
            reloaded = registry.reload("hot_pass_mod")
            assert "hot_pass_mod" in reloaded
            assert np.asarray(frame(x))[0] == 3.0
        finally:
            sys.path.remove(str(tmp_path))
            sys.modules.pop("hot_pass_mod", None)

    def test_pass_graph_dump(self):
        from vkr.core.graph import PassGraph, add_task

        g = PassGraph()
        with g.recording():
            add_task("A", lambda x: x * 2, jnp.ones((4, 4)))
            add_task("B", lambda x: x + 1, jnp.ones((4, 4)))
        dump = g.dump()
        assert "A" in dump and "B" in dump and "float32[4, 4]" in dump
