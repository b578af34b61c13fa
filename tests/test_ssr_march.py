"""The SSR march kernel (ssr_march.march_kernel, Triton route in
interpret mode) vs the plain XLA march."""

import numpy as np
import jax.numpy as jnp
import pytest

from vkr.mathlib import encode_normal, look_at, perspective
from vkr.mathlib.transforms import normal_matrix
from vkr.passes.downsample import build_hiz
from vkr.passes import ssr as S
from vkr.passes.ssr_march import march_kernel, march_plain
from vkr.raster import rasterize


def _scene(H=64, W=64):
    """Mirror floor + back wall (the TestSimpleSSR scene)."""
    view = look_at((0, 1.0, -2.0), (0, 0.8, 1.0), (0, -1, 0))
    proj = perspective(np.radians(60), 1.0, 0.05, 80.0)
    vp = proj @ view
    world = np.array(
        [[-4, 0, -4, 1], [4, 0, -4, 1], [4, 0, 3, 1], [-4, 0, 3, 1],
         [-4, 0, 3, 1], [4, 0, 3, 1], [4, 3, 3, 1], [-4, 3, 3, 1]],
        np.float32,
    )
    clip = jnp.asarray(world @ vp.T)
    idx = jnp.asarray([[0, 1, 2], [0, 2, 3], [4, 5, 6], [4, 6, 7]],
                      jnp.int32)
    vis = rasterize(clip, idx, width=W, height=H, use_pallas=False)
    src = np.asarray(vis.src)[np.maximum(np.asarray(vis.tri_id), 0)]
    nrm = np.where((src >= 2)[..., None], [0.0, 0.0, -1.0],
                   [0.0, 1.0, 0.0])
    noct = encode_normal(jnp.asarray(nrm))
    hiz = build_hiz(vis.depth, noct, jnp.zeros((H, W, 2)))
    p = S.SSRParams(normal_mat=jnp.asarray(normal_matrix(view)),
                    fovy=np.radians(60), aspect=1.0, znear=0.05,
                    zfar=80.0)
    return hiz, p


def _rays(hiz, params):
    """Deterministic mirror rays off the G-buffer (the ssr_trace ray
    setup with roughness 0 so VNDF == normal)."""
    from vkr.mathlib.octahedral import decode_normal
    from vkr.mathlib.projection import (project_view_vec,
                                            reconstruct_view_vec)
    from vkr.passes.sampling import screen_uv_grid

    pyr = S.pack_pyramid(hiz.mips)
    h, w = pyr.heights[0], pyr.widths[0]
    uv = screen_uv_grid(h, w)
    depth = pyr.flat[: h * w].reshape(h, w)
    n = decode_normal(hiz.normal_half)
    nm = jnp.asarray(params.normal_mat)
    n = n @ nm[:3, :3].T
    n = n / jnp.linalg.norm(n, axis=-1, keepdims=True).clip(1e-20)
    view_vec = reconstruct_view_vec(uv, depth, params.fovy, params.aspect,
                                    params.znear, params.zfar)
    r = view_vec - 2.0 * (view_vec * n).sum(-1, keepdims=True) * n
    ray_start = project_view_vec(view_vec + 0.001 * n, params.fovy,
                                 params.aspect, params.znear, params.zfar)
    ray_start = ray_start.at[..., 2].add(-0.0001)
    ray_dir = project_view_vec(view_vec + r, params.fovy, params.aspect,
                               params.znear, params.zfar) - ray_start
    scale = (1.0 - ray_start[..., 2]) / jnp.where(
        jnp.abs(ray_dir[..., 2]) < 1e-20, 1e-20, ray_dir[..., 2]
    )
    ray_dir = ray_dir * scale[..., None]
    w0 = -view_vec / jnp.linalg.norm(view_vec, axis=-1,
                                     keepdims=True).clip(1e-20)
    return pyr, ray_start, ray_dir, view_vec, w0


class TestPallasMarch:
    def test_matches_oracle_march(self):
        MAX_IT = 48
        hiz, params = _scene()
        pyr, o, d, cam, w0 = _rays(hiz, params)

        pos_ref, hor_ref, it_ref = march_plain(
            pyr, o, d, cam, w0, params, MAX_IT)
        pos_k, hor_k, it_k = march_kernel(
            pyr, o, d, cam, w0, params, MAX_IT, interpret=True)
        assert pos_k.shape == pos_ref.shape and it_k.dtype == it_ref.dtype

        # One transcription of the step runs both ways; in the
        # interpreter the arithmetic is the same XLA:CPU code, so every
        # ray must agree (on the card FMA contraction may flip a few
        # knife-edge DDA decisions: chip_smoke.py allows 0.1%).
        valid_ref = np.asarray(it_ref) <= MAX_IT
        valid_k = np.asarray(it_k) <= MAX_IT
        agree = (valid_ref == valid_k).mean()
        assert agree >= 0.999, f"validity agreement {agree}"
        both = valid_ref & valid_k
        assert both.any()
        dp = np.abs(np.asarray(pos_k) - np.asarray(pos_ref))[both]
        assert dp[..., :2].max() < 1.0 / 64.0  # within one texel
        dh = np.abs(np.asarray(hor_k) - np.asarray(hor_ref))
        assert np.percentile(dh, 99) < 1e-4

    def test_trace_level_parity(self):
        """ssr_trace(use_pallas=True) ~ ssr_trace(False) on the mirror
        scene (stochastic pass; compare hit-validity rate + uv error)."""
        hiz, params = _scene()
        pyr = S.pack_pyramid(hiz.mips)
        from vkr.frame import build_ssr_resources

        res = build_ssr_resources(32)
        material = jnp.full((128, 128, 4), 0.1)  # low roughness
        kw = dict(max_iterations=48)
        rays_a, occ_a = S.ssr_trace(pyr, hiz.normal_half, material,
                                    res.pdf_lut, params,
                                    jnp.asarray(0, jnp.int32), res.halton,
                                    **kw)
        rays_b, occ_b = S.ssr_trace(pyr, hiz.normal_half, material,
                                    res.pdf_lut, params,
                                    jnp.asarray(0, jnp.int32), res.halton,
                                    use_pallas=True, interpret=True, **kw)
        va = np.asarray(rays_a[..., 3]) != 1.0
        vb = np.asarray(rays_b[..., 3]) != 1.0
        assert (va == vb).mean() > 0.95
        both = va & vb
        if both.any():
            duv = np.abs(np.asarray(rays_a[..., :2] - rays_b[..., :2]))
            assert np.percentile(duv[both].max(-1), 90) < 2.0 / 64.0
        d_occ = np.abs(np.asarray(occ_a - occ_b))
        assert np.percentile(d_occ, 90) < 0.05


class TestAnalyticGroundTruth:
    """Analytic golden: hit positions derived from GEOMETRY, independent
    of both march implementations (chips at the shared-misreading risk,
    docs/GROUND_TRUTH.md). Mirror floor at y=0 with a back wall at z=3:
    a floor pixel's mirror ray must hit the wall at the reflection of
    the camera across the floor plane."""

    def test_hits_match_geometric_reflection(self):
        from vkr.mathlib import look_at, perspective

        MAX_IT = 64
        hiz, params = _scene(128, 128)
        pyr, o, d, cam, w0 = _rays(hiz, params)
        pos, hor, it = march_kernel(pyr, o, d, cam, w0, params, MAX_IT,
                                    interpret=True)
        pos = np.asarray(pos)
        valid = np.asarray(it) <= MAX_IT

        # analytic expectation, built only from the scene's geometry
        view = look_at((0, 1.0, -2.0), (0, 0.8, 1.0), (0, -1, 0))
        proj = perspective(np.radians(60), 1.0, 0.05, 80.0)
        vp = np.asarray(proj @ view)
        inv_view = np.linalg.inv(np.asarray(view))
        cam_pos = inv_view[:3, 3]
        h, w = pos.shape[:2]

        from vkr.mathlib.projection import reconstruct_view_vec
        from vkr.passes.sampling import screen_uv_grid

        depth0 = np.asarray(hiz.mips[0])
        uv = np.asarray(screen_uv_grid(h, w))
        vv = np.asarray(reconstruct_view_vec(
            jnp.asarray(uv), jnp.asarray(depth0), params.fovy,
            params.aspect, params.znear, params.zfar))
        wp_ = vv @ inv_view[:3, :3].T + cam_pos

        # floor pixels away from edges, with valid hits
        floor = (np.abs(wp_[..., 1]) < 0.05) & (depth0 < 1.0)
        floor &= (wp_[..., 2] > -1.0) & (wp_[..., 2] < 2.0)
        m = floor & valid
        assert m.sum() > 200, m.sum()

        # mirror the camera across y=0; the reflected sight line from
        # the mirrored camera through the floor point hits the wall z=3
        cam_m = cam_pos * np.array([1, -1, 1])
        dirs = wp_ - cam_m
        t_wall = (3.0 - cam_m[2]) / dirs[..., 2]
        hit_w = cam_m + t_wall[..., None] * dirs
        on_wall = (hit_w[..., 1] > 0.05) & (hit_w[..., 1] < 2.9)
        m &= on_wall
        assert m.sum() > 100, m.sum()

        # project the analytic wall hit to screen uv
        hp4 = np.concatenate([hit_w, np.ones(hit_w.shape[:-1] + (1,))],
                             -1) @ vp.T
        exp_uv = 0.5 * hp4[..., :2] / hp4[..., 3:4] + 0.5

        err = np.abs(pos[..., :2] - exp_uv)[m].max(-1)
        # sub-2-texel agreement for the bulk of floor pixels
        assert np.percentile(err, 80) < 2.0 / w, np.percentile(err, 80)
        assert np.median(err) < 1.0 / w


class TestMarchKernelWrapper:
    def test_partial_block_shapes(self):
        """Ray counts that are not a multiple of RAY_BLOCK: the wrapper
        pads with retired rays and crops back to the leading shape."""
        from vkr.passes.ssr_march import RAY_BLOCK

        hiz, params = _scene(32, 32)
        pyr, o, d, cam, w0 = _rays(hiz, params)
        sl = (slice(3, 13), slice(0, 13))  # 130 rays
        assert (10 * 13) % RAY_BLOCK != 0
        args = [a[sl] for a in (o, d, cam, w0)]
        pos, hor, it = march_kernel(pyr, *args, params, 24, interpret=True)
        assert pos.shape == (10, 13, 3) and hor.shape == it.shape == (10, 13)
        pos_p, hor_p, it_p = march_plain(pyr, *args, params, 24)
        np.testing.assert_array_equal(np.asarray(it), np.asarray(it_p))
        np.testing.assert_allclose(np.asarray(pos), np.asarray(pos_p),
                                   atol=1e-6)


@pytest.mark.gpu
def test_compiled_march_kernel_matches_plain(gpu_device):
    """The compiled Triton march vs the plain XLA march (chip check;
    chip_smoke.py runs it at bench size)."""
    hiz, params = _scene(128, 128)
    pyr, o, d, cam, w0 = _rays(hiz, params)
    _, _, it_k = march_kernel(pyr, o, d, cam, w0, params, 80)
    _, _, it_p = march_plain(pyr, o, d, cam, w0, params, 80)
    agree = ((np.asarray(it_k) <= 80) == (np.asarray(it_p) <= 80)).mean()
    assert agree >= 0.999
