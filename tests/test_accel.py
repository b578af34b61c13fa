"""Scene acceleration structure (scene/accel.py) + ray-query GTAO.

Reference: src/scene/scene_as.cpp (BLAS/TLAS build) and
shaders/gtao/rt_main.frag (consumer semantics)."""

import numpy as np
import jax
import jax.numpy as jnp

from vkr.scene.accel import (TriGrid, build_tri_grid, _tri_hit_mask,
                                 ray_any_hit)


def _brute_any_hit(tri, orig, dirs, t_max):
    """All-triangles Moller-Trumbore oracle."""
    v0 = tri[:, 0]
    e1 = tri[:, 1] - tri[:, 0]
    e2 = tri[:, 2] - tri[:, 0]
    m = _tri_hit_mask(
        orig[:, None, :], dirs[:, None, :], v0[None], e1[None], e2[None],
        jnp.asarray(t_max)[:, None],
    )
    return np.asarray(m.any(-1))


class TestTriGrid:
    def test_any_hit_matches_bruteforce(self):
        rng = np.random.default_rng(3)
        n_tri, n_ray = 60, 256
        centers = rng.uniform(0, 1, (n_tri, 1, 3))
        tri = centers + rng.uniform(-0.12, 0.12, (n_tri, 3, 3))
        verts = tri.reshape(-1, 3)
        idx = np.arange(n_tri * 3).reshape(-1, 3)
        grid = build_tri_grid(verts, idx, resolution=10, cap=48)
        assert grid.overflowed == 0

        orig = rng.uniform(0.05, 0.95, (n_ray, 3)).astype(np.float32)
        d = rng.normal(size=(n_ray, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        t_max = rng.uniform(0.05, 0.6, n_ray).astype(np.float32)

        got = np.asarray(ray_any_hit(grid, jnp.asarray(orig),
                                     jnp.asarray(d),
                                     jnp.asarray(t_max)))
        want = _brute_any_hit(jnp.asarray(tri, jnp.float32),
                              jnp.asarray(orig), jnp.asarray(d), t_max)
        assert (got == want).all(), (
            f"{(got != want).sum()} of {n_ray} rays disagree"
        )

    def test_short_ray_step_bound(self):
        """With max_steps sized for the segment, results still match."""
        rng = np.random.default_rng(5)
        tri = rng.uniform(0, 1, (30, 3, 3))
        verts = tri.reshape(-1, 3)
        idx = np.arange(90).reshape(-1, 3)
        grid = build_tri_grid(verts, idx, resolution=8, cap=64)
        orig = rng.uniform(0.2, 0.8, (128, 3)).astype(np.float32)
        d = rng.normal(size=(128, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        t_max = 0.15
        # 0.15 world units spans at most ceil(0.15/cell)*3 + 2 cells
        cell_min = float(np.asarray(grid.cell_size).min())
        steps = int(np.ceil(t_max / cell_min)) * 3 + 2
        a = np.asarray(ray_any_hit(grid, orig, d, t_max))
        b = np.asarray(ray_any_hit(grid, orig, d, t_max,
                                   max_steps=steps))
        assert (a == b).all()


class TestGTAORT:
    def _plane_scene(self, with_blocker):
        """Ground plane at y=0 (two big triangles), optionally a low
        square blocker hovering right above the origin."""
        verts = [
            [-5, 0, -5], [5, 0, -5], [5, 0, 5], [-5, 0, 5],
        ]
        tris = [[0, 1, 2], [0, 2, 3]]
        if with_blocker:
            b = len(verts)
            verts += [[-0.5, 0.05, -0.5], [0.5, 0.05, -0.5],
                      [0.5, 0.05, 0.5], [-0.5, 0.05, 0.5]]
            tris += [[b, b + 1, b + 2], [b, b + 2, b + 3]]
        return (np.asarray(verts, np.float32),
                np.asarray(tris, np.int32))

    def test_visibility_under_blocker(self):
        from vkr.passes.gtao import ao_ray_directions

        dirs = ao_ray_directions(64)
        for with_blocker, expect_occluded in ((False, False),
                                              (True, True)):
            verts, tris = self._plane_scene(with_blocker)
            grid = build_tri_grid(verts, tris, resolution=16, cap=16)
            # hemisphere rays from just above the plane at the origin
            orig = np.broadcast_to(
                np.asarray([0.0, 1e-4, 0.0], np.float32), (64, 3)
            )
            # local z = up
            d = np.stack([dirs[:, 0], dirs[:, 2], dirs[:, 1]], -1)
            hit = np.asarray(ray_any_hit(grid, orig, d, 0.2))
            if expect_occluded:
                # rays too shallow to climb 0.05 units within the 0.2
                # range legitimately miss; the rest must hit the blocker
                must_hit = d[:, 1] * 0.2 > 0.05 + 1e-3
                assert hit[must_hit].all(), (
                    "blocker at 0.05 must block steep rays"
                )
            else:
                assert not hit.any(), "open plane must block nothing"

    def test_gtao_rt_pass(self):
        """Run the registered pass on the mirror corner scene: corner
        rows (floor meets wall) must be darker than open floor."""
        import sys
        sys.path.insert(0, "tests")
        from test_ssr_march import _scene

        from vkr.core import registry
        from vkr.frame import _inv4, _rt_direction_table
        from vkr.mathlib import look_at

        hiz, params = _scene()
        depth_half = hiz.mips[0]
        view = look_at((0, 1.0, -2.0), (0, 0.8, 1.0), (0, -1, 0))
        inv_view = np.asarray(_inv4(jnp.asarray(view)))
        world = np.array(
            [[-4, 0, -4], [4, 0, -4], [4, 0, 3], [-4, 0, 3],
             [-4, 0, 3], [4, 0, 3], [4, 3, 3], [-4, 3, 3]], np.float32,
        )
        idx = np.asarray([[0, 1, 2], [0, 2, 3], [4, 5, 6], [4, 6, 7]],
                         np.int32)
        grid = build_tri_grid(world, idx, resolution=12, cap=8)
        dirs = jnp.asarray(_rt_direction_table(64))
        ao = np.asarray(registry.get("gtao_rt")(
            depth_half, hiz.normal_half, grid, jnp.asarray(inv_view),
            np.radians(60), 1.0, 0.05, 80.0, 0.0, dirs,
            rt_radius=0.5, max_steps=10,
        ))
        h, w = ao.shape
        assert np.isfinite(ao).all()
        assert 0.0 <= ao.min() and ao.max() <= 1.6
        # world-space masks: floor pixels near the wall (z > 2.6, within
        # the 0.5 ray range of it) must be darker than open floor
        from vkr.mathlib.octahedral import decode_normal
        from vkr.mathlib.projection import reconstruct_view_vec
        from vkr.passes.sampling import screen_uv_grid

        uv = screen_uv_grid(h, w)
        vv = np.asarray(reconstruct_view_vec(
            uv, depth_half, np.radians(60), 1.0, 0.05, 80.0))
        wp = vv @ inv_view[:3, :3].T + inv_view[:3, 3]
        nrm = np.asarray(decode_normal(hiz.normal_half))
        valid = np.asarray(depth_half) < 1.0
        floor = valid & (np.abs(nrm[..., 1]) > 0.9)
        near_wall = floor & (wp[..., 2] > 2.6)
        open_floor = floor & (wp[..., 2] < 1.5)
        assert near_wall.any() and open_floor.any()
        assert ao[near_wall].mean() < ao[open_floor].mean() - 0.05
