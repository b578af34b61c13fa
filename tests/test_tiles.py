"""SSR tile classification/regression + GTAO deinterleave tests."""

import numpy as np
import jax.numpy as jnp

from vkr.mathlib import look_at
from vkr.mathlib.projection import encode_depth
from vkr.mathlib.transforms import inverse_rigid


class TestClassification:
    def test_partition(self):
        from vkr.passes.ssr_tiles import classify_tiles

        h = w = 32  # 4x4 tiles
        mat = np.zeros((h, w, 4), np.float32)
        mat[:, :, 1] = 0.8          # glossy everywhere...
        mat[:8, :8, 1] = 0.05       # ...except one mirror tile
        c = classify_tiles(jnp.asarray(mat), max_roughness=1.0,
                           glossy_value=0.2)
        assert int(c.reflective_count) == 1
        assert int(c.glossy_count) == 15
        assert bool(c.is_reflective[0, 0])
        refl = np.asarray(c.reflective_tiles)
        assert refl[0] == 0 and np.all(refl[1:] == -1)
        # packed glossy list holds the other 15 ids
        gl = np.asarray(c.glossy_tiles)
        assert set(gl[:15]) == set(range(1, 16))

    def test_indirect_mask(self):
        from vkr.passes.ssr_tiles import (classify_tiles,
                                              trace_indirect_mask)

        h = w = 16
        mat = np.full((h, w, 4), 0.9, np.float32)
        mat[8:, :8, 1] = 0.0
        c = classify_tiles(jnp.asarray(mat), 1.0, 0.2)
        m = np.asarray(trace_indirect_mask(c, h, w))
        assert m[12, 4] and not m[4, 4] and not m[12, 12]


class TestRegression:
    def test_plane_fit_on_flat_floor(self):
        """Points on the plane y=1 (world, camera-relative): fitted plane p
        must satisfy dot(p, x) = 1 -> p ~ (0, 1, 0), mse ~ 0."""
        from vkr.passes.ssr_tiles import tile_plane_regression

        h = w = 16
        fovy, aspect, zn, zf = np.radians(60), 1.0, 0.05, 80.0
        view = look_at((0, 0, 0), (0, 0.3, 1), (0, -1, 0))
        inv = inverse_rigid(view)
        # build depth of the plane y_world - y_cam = 1 by raytracing
        ys, xs = np.meshgrid((np.arange(h) + 0.0) / h,
                             (np.arange(w) + 0.0) / w, indexing="ij")
        tg = np.tan(fovy / 2)
        # match reconstruct_view_vec: x = -(2u-1) * z * aspect * tg with
        # z negative -> +(2u-1) * t * aspect * tg
        dir_cam = np.stack([(2 * xs - 1) * tg * aspect,
                            (2 * ys - 1) * tg, -np.ones_like(xs)], -1)
        dir_world = dir_cam @ inv[:3, :3].T
        t = np.where(dir_world[..., 1] > 1e-3, 1.0 / dir_world[..., 1],
                     np.nan)
        ok = np.isfinite(t) & (t > 0) & (t < 40.0)  # inside zfar
        zview = np.where(ok, -t, -10.0)
        depth = np.clip(np.asarray(
            encode_depth(jnp.asarray(zview), zn, zf)), 0, 1)
        planes = np.asarray(
            tile_plane_regression(jnp.asarray(depth), jnp.asarray(inv),
                                  fovy, aspect, zn, zf)
        )
        # tiles fully on the plane: dot(p, x_i) ~ 1 (tiny reported mse) —
        # the normal-equation solution (same system the reference solves)
        # need not be the geometric normal for near-degenerate tiles.
        pts = t[..., None] * dir_world
        tile_ok = ok.reshape(2, 8, 2, 8).all(axis=(1, 3))
        any_checked = False
        for i in range(2):
            for j in range(2):
                if tile_ok[i, j]:
                    any_checked = True
                    assert planes[i, j, 3] < 1e-4, planes[i, j]
                    tp = pts[8 * i : 8 * i + 8, 8 * j : 8 * j + 8]
                    res = tp @ planes[i, j, :3] - 1.0
                    assert np.abs(res).max() < 0.05, np.abs(res).max()
        assert any_checked


class TestDeinterleave:
    def test_round_trip(self):
        from vkr.passes.gtao import (deinterleave_depth,
                                         interleave_layers)

        rng = np.random.default_rng(0)
        d = jnp.asarray(rng.random((32, 64)), jnp.float32)
        layers = deinterleave_depth(d, 2)
        assert layers.shape == (16, 8, 16)
        back = interleave_layers(layers, 2)
        np.testing.assert_array_equal(np.asarray(back), np.asarray(d))

    def test_layer_extraction(self):
        from vkr.passes.gtao import deinterleave_depth

        h = w = 8
        d = np.arange(h * w, dtype=np.float32).reshape(h, w)
        layers = np.asarray(deinterleave_depth(jnp.asarray(d), 1))
        # layer 0 = even rows/cols; layer 1 = even rows, odd cols
        np.testing.assert_array_equal(layers[0], d[::2, ::2])
        np.testing.assert_array_equal(layers[1], d[::2, 1::2])
        np.testing.assert_array_equal(layers[2], d[1::2, ::2])

    def test_deinterleaved_gtao_close_to_plain(self):
        from vkr.mathlib import encode_normal
        from vkr.passes.gtao import (GTAOParams, gtao_filter,
                                         gtao_main_deinterleaved)

        H = W = 64
        depth = jnp.full(
            (H, W), float(encode_depth(jnp.asarray(-5.0), 0.05, 80.0))
        )
        noct = encode_normal(
            jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), (H, W, 3))
        )
        p = GTAOParams(normal_mat=jnp.eye(4), fovy=np.radians(60),
                       aspect=1.0, znear=0.05, zfar=80.0)
        ao = gtao_main_deinterleaved(depth, noct, p, jnp.asarray(0.0))
        filt = np.asarray(gtao_filter(depth, ao, 0.05, 80.0))[8:-8, 8:-8]
        assert abs(filt.mean() - 1.0) < 0.05
