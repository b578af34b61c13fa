"""Multi-device rendering tests on the virtual 8-device CPU mesh
(conftest sets xla_force_host_platform_device_count=8)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest


@pytest.mark.skipif(len(jax.devices()) < 4, reason="needs >= 4 devices")
@pytest.mark.slow
def test_view_parallel_rendering():
    import dataclasses

    from vkr.config import RenderConfig
    from vkr.core.framestate import FrameState
    from vkr.frame import build_ssr_resources, camera_frame
    from vkr.mathlib import look_at
    from vkr.parallel import make_render_mesh, render_views_sharded
    from vkr.parallel.sharding import batch_cams, batch_states
    from vkr.passes.gbuffer import upload_scene
    from vkr.scene import colonnade_scene

    n = 4
    cfg = RenderConfig(width=64, height=64)
    cfg = dataclasses.replace(
        cfg, ssr=dataclasses.replace(cfg.ssr, max_iterations=8)
    )
    scene = upload_scene(
        colonnade_scene(columns=2, tessellation=6, tex_size=32)
    )
    res = build_ssr_resources(32)
    mesh = make_render_mesh(n)

    cams = []
    for i in range(n):
        ang = 2 * np.pi * i / n
        eye = (4 + 5 * np.cos(ang), 2.0, 0.5 + 3 * np.sin(ang))
        v = look_at(eye, (4, 1.8, 0.5), (0, -1, 0))
        cams.append(camera_frame(cfg, v, v, i))
    cams_b = batch_cams(cams)
    states_b = batch_states(
        lambda: FrameState.initial(cfg.height, cfg.width), n
    )

    colors, new_states = jax.jit(
        lambda s, st, c, r: render_views_sharded(
            s, st, c, r, cfg, mesh, use_pallas=True, interpret=True
        )
    )(scene, states_b, cams_b, res)
    colors = np.asarray(colors)
    assert colors.shape == (n, 64, 64, 3)
    assert np.isfinite(colors).all()
    # each view sees geometry and the views differ
    cov = np.asarray(new_states.prev_depth) < 1.0
    assert cov.reshape(n, -1).mean(axis=1).min() > 0.05
    assert not np.allclose(colors[0], colors[1])


@pytest.mark.parametrize("n_bands", [2, 4])
def test_band_viewport_raster_matches_full(n_bands):
    """Band-viewport mode: rendering the frame as bands must reproduce
    the full-frame visibility buffer, also where the band rows do not
    start on the 16-row tile grid (bands of 36 and 18 rows)."""
    from vkr.raster import rasterize

    rng = np.random.default_rng(5)
    n = 40
    center = rng.uniform(-1.2, 1.2, (n, 1, 2))
    offs = rng.uniform(-0.4, 0.4, (n, 3, 2))
    z = rng.uniform(0.05, 0.95, (n, 3, 1))
    v = np.concatenate([center + offs, z, np.ones((n, 3, 1))],
                       -1).astype(np.float32)
    clip = jnp.asarray(v.reshape(-1, 4))
    idx = jnp.arange(n * 3, dtype=jnp.int32).reshape(n, 3)

    H, W = 72, 128
    bh = H // n_bands
    full = rasterize(clip, idx, width=W, height=H, use_pallas=True,
                     interpret=True)
    bands = []
    for b in range(n_bands):
        vis = rasterize(
            clip, idx, width=W, height=bh, use_pallas=True,
            interpret=True, full_height=H,
            y_offset=jnp.asarray(b * bh, jnp.float32),
        )
        bands.append(vis)
    depth_bands = np.concatenate(
        [np.asarray(b.depth) for b in bands], axis=0
    )
    tid_bands = np.concatenate(
        [np.asarray(b.tri_id) for b in bands], axis=0
    )
    # BAND-EXACT: the edge/depth coefficients stay in full-frame float
    # coordinates (no translation) and the kernel offsets its pixel
    # rows, so banded output is bitwise identical to the full frame.
    tid_full = np.asarray(full.tri_id)
    np.testing.assert_array_equal(tid_bands, tid_full)
    np.testing.assert_array_equal(depth_bands, np.asarray(full.depth))


@pytest.mark.slow
def test_band_sharded_frame_bit_matches_single_device():
    """parallel/band.py: the band-sharded FULL frame (sharded raster +
    gathered image-space chain) matches the single-device frame.

    The raster-owned history (prev_depth) must be BITWISE identical
    (band-exact viewports, no float translation). The shaded color /
    TAA chain is held to 1e-6 — the MIS GTAO default path introduced a
    last-ulp reassociation between the banded and full graphs (measured
    max 9.3e-10 on 0.08% of pixels; display precision is 1/255 ~ 4e-3),
    which no bitwise claim survives."""
    import dataclasses

    import jax
    from jax.sharding import Mesh

    from vkr.config import RenderConfig
    from vkr.core.framestate import FrameState
    from vkr.frame import (build_ssr_resources, camera_frame,
                               render_frame)
    from vkr.mathlib import look_at
    from vkr.parallel import render_frame_banded
    from vkr.passes.gbuffer import upload_scene
    from vkr.scene import colonnade_scene

    H = W = 64
    cfg = RenderConfig(width=W, height=H)
    cfg = dataclasses.replace(
        cfg, ssr=dataclasses.replace(cfg.ssr, max_iterations=8)
    )
    scene = upload_scene(
        colonnade_scene(columns=2, tessellation=6, tex_size=32)
    )
    res = build_ssr_resources(32)
    view = look_at((-6, 2.2, -2), (4, 1.8, 0.5), (0, -1, 0))
    cam = camera_frame(cfg, view, view, 0)

    color_1, state_1, _ = render_frame(
        scene, FrameState.initial(H, W), cam, res, cfg,
        use_pallas=True, interpret=True,
    )

    mesh = Mesh(np.asarray(jax.devices()[:4]), ("bands",))
    color_b, state_b, aux_b = render_frame_banded(
        scene, FrameState.initial(H, W), cam, res, cfg, mesh,
        use_pallas=True, interpret=True,
    )

    np.testing.assert_allclose(np.asarray(color_b),
                               np.asarray(color_1), atol=1e-6, rtol=0)
    np.testing.assert_allclose(np.asarray(state_b.taa_history),
                               np.asarray(state_1.taa_history),
                               atol=1e-6, rtol=0)
    np.testing.assert_array_equal(np.asarray(state_b.prev_depth),
                                  np.asarray(state_1.prev_depth))
    assert int(np.asarray(aux_b["overflow"])) == 0


@pytest.mark.slow
def test_band_oracle_resolve_matches_full_frame():
    """Band-exact mode with the XLA-fallback resolve (use_pallas=False):
    the edge/depth planes stay in full-frame coordinates, so the oracle's
    attribute resolve must evaluate band pixels at their GLOBAL rows
    (raster/resolve.pixel_barycentrics row_offset). Regression test for a
    bug where band G-buffers interpolated attributes at band-local rows."""
    from vkr.mathlib import look_at
    from vkr.mathlib.transforms import perspective
    from vkr.passes.gbuffer import render_gbuffer, upload_scene
    from vkr.scene import colonnade_scene

    scene = upload_scene(
        colonnade_scene(columns=2, tessellation=6, tex_size=32)
    )
    H, W = 64, 128
    view = look_at((-6, 2.2, -2), (4, 1.8, 0.5), (0, -1, 0))
    proj = perspective(75.0, W / H, 0.05, 80.0)
    vp = jnp.asarray(proj @ view, jnp.float32)
    jit = jnp.zeros(2, jnp.float32)

    full = render_gbuffer(scene, vp, vp, jit, width=W, height=H,
                          use_pallas=False)
    for b in range(2):
        r0 = b * (H // 2)
        band = render_gbuffer(
            scene, vp, vp, jit, width=W, height=H // 2,
            use_pallas=False, full_height=H, row_offset=r0,
        )
        for name in ("albedo", "normal", "depth", "velocity"):
            np.testing.assert_array_equal(
                np.asarray(getattr(band, name)),
                np.asarray(getattr(full, name))[r0:r0 + H // 2],
                err_msg=f"band {b} {name}",
            )


@pytest.mark.slow
def test_band_frame_with_ray_query_gtao():
    """Band mode with the ray-query GTAO variant (gtao_rt row-origin
    path) must match the single-device frame."""
    import dataclasses

    from vkr.config import GTAOConfig, RenderConfig
    from vkr.core.framestate import FrameState
    from vkr.frame import (build_scene_tri_grid, build_ssr_resources,
                               camera_frame, render_frame)
    from vkr.mathlib import look_at
    from vkr.parallel import render_frame_banded
    from vkr.passes.gbuffer import upload_scene
    from vkr.scene import colonnade_scene
    from jax.sharding import Mesh

    H = W = 64
    cfg = RenderConfig(
        width=W, height=H, enable_ssr=False, enable_taa=False,
        gtao=GTAOConfig(use_ray_query=True, rt_directions=8),
    )
    scene_cpu = colonnade_scene(columns=2, tessellation=6, tex_size=32)
    scene = upload_scene(scene_cpu)
    grid = build_scene_tri_grid(scene_cpu, resolution=12, cap=32)
    res = build_ssr_resources(32)
    view = look_at((-6, 2.2, -2), (4, 1.8, 0.5), (0, -1, 0))
    cam = camera_frame(cfg, view, view, 0)

    color_1, _, _ = render_frame(
        scene, FrameState.initial(H, W), cam, res, cfg, tri_grid=grid,
        use_pallas=True, interpret=True,
    )
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("bands",))
    color_b, _, _ = render_frame_banded(
        scene, FrameState.initial(H, W), cam, res, cfg, mesh,
        tri_grid=grid, use_pallas=True, interpret=True,
    )
    np.testing.assert_allclose(np.asarray(color_b), np.asarray(color_1),
                               atol=1e-5)


@pytest.mark.parametrize("band", [0, 2])
def test_band_ssr_filter_matches_full_rows(band):
    """ssr_filter in band mode: the neighbour taps step one texel of the
    FULL image (dy / H), so each band's rows equal the full-frame rows
    (to float rounding of the separately compiled programs)."""
    import jax
    import jax.numpy as jnp

    from vkr.passes.ssr import SSRParams, ssr_filter

    H, W, n = 16, 24, 4
    bh = H // n
    rng = np.random.default_rng(band)
    rays = np.concatenate(
        [rng.uniform(0.05, 0.95, (H, W, 2)), rng.uniform(0.9, 0.99, (H, W, 1)),
         np.where(rng.random((H, W, 1)) < 0.7, 0.95, 1.0)], -1)
    args = (jnp.asarray(rays, jnp.float32),
            jnp.asarray(rng.uniform(0.9, 0.99, (H, W)), jnp.float32),
            jnp.asarray(rng.random((2 * H, 2 * W, 4)), jnp.float32),
            jnp.asarray(rng.random((H, W, 2)), jnp.float32),
            jnp.asarray(rng.random((2 * H, 2 * W, 4)), jnp.float32))
    p = SSRParams(normal_mat=jnp.eye(4), fovy=1.0, aspect=W / H,
                  znear=0.1, zfar=50.0)
    full = np.asarray(jax.jit(lambda *a: ssr_filter(*a, p))(*args))
    rows = np.asarray(jax.jit(
        lambda r0, *a: ssr_filter(*a, p, row0=r0, band_h=bh))(
            jnp.int32(band * bh), *args))
    np.testing.assert_allclose(rows, full[band * bh:(band + 1) * bh],
                               rtol=1e-4, atol=1e-5)
