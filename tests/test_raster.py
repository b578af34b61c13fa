"""Rasterizer tests: analytic coverage, Pallas-vs-oracle equivalence,
near clipping, perspective-correct interpolation (SURVEY.md §4 rebuild
implication: analytic-scene rasterizer tests)."""

import numpy as np
import jax.numpy as jnp
import pytest

from vkr.mathlib import look_at, perspective
from vkr.raster import (
    clip_near_triangles,
    corner_attributes,
    interpolate,
    pixel_barycentrics,
    rasterize,
    rasterize_reference,
    triangle_setup,
)


def ndc_tri_clip(v_ndc):
    """Build clip positions (w=1) straight from NDC coords."""
    v = np.asarray(v_ndc, np.float32)
    out = np.concatenate([v, np.ones((len(v), 1), np.float32)], axis=-1)
    return jnp.asarray(out)


class TestCoverage:
    def test_fullscreen_quad_covers_everything(self):
        clip = ndc_tri_clip(
            [[-1, -1, 0.5], [3, -1, 0.5], [-1, 3, 0.5]]
        )
        vis = rasterize(
            clip, jnp.asarray([[0, 1, 2]], jnp.int32),
            width=128, height=64, use_pallas=False,
        )
        assert np.all(np.asarray(vis.tri_id) == 0)
        assert np.allclose(np.asarray(vis.depth), 0.5, atol=1e-6)

    def test_half_triangle_coverage_fraction(self):
        # Triangle covering the left half of the screen (diagonal split).
        clip = ndc_tri_clip([[-1, -1, 0.5], [1, -1, 0.5], [-1, 1, 0.5]])
        vis = rasterize(
            clip, jnp.asarray([[0, 1, 2]], jnp.int32),
            width=256, height=256, use_pallas=False,
        )
        frac = np.mean(np.asarray(vis.tri_id) >= 0)
        assert abs(frac - 0.5) < 0.01

    def test_winding_is_irrelevant(self):
        # cull mode NONE (pipelines.hpp:113): both windings rasterize.
        clip = ndc_tri_clip([[-1, -1, 0.5], [1, -1, 0.5], [-1, 1, 0.5]])
        vis_ccw = rasterize(clip, jnp.asarray([[0, 1, 2]], jnp.int32),
                            width=64, height=64, use_pallas=False)
        vis_cw = rasterize(clip, jnp.asarray([[0, 2, 1]], jnp.int32),
                           width=64, height=64, use_pallas=False)
        assert np.array_equal(np.asarray(vis_ccw.tri_id),
                              np.asarray(vis_cw.tri_id))

    def test_shared_edge_no_double_coverage_no_gap(self):
        # Two triangles forming a quad: every interior pixel covered exactly
        # once (top-left fill rule).
        clip = ndc_tri_clip([
            [-0.5, -0.5, 0.5], [0.5, -0.5, 0.5],
            [0.5, 0.5, 0.5], [-0.5, 0.5, 0.5],
        ])
        idx = jnp.asarray([[0, 1, 2], [0, 2, 3]], jnp.int32)
        vis = rasterize(clip, idx, width=64, height=64, use_pallas=False)
        tid = np.asarray(vis.tri_id)
        covered = (tid >= 0).mean()
        assert abs(covered - 0.25) < 0.02
        # Depth equal on both: shared-edge pixels must never be background
        # inside the quad. Check a vertical line through the middle.
        assert np.all(tid[20:44, 32] >= 0)

    def test_depth_test_closest_wins(self):
        clip = ndc_tri_clip([
            [-1, -1, 0.8], [3, -1, 0.8], [-1, 3, 0.8],   # far, fullscreen
            [-1, -1, 0.2], [3, -1, 0.2], [-1, 3, 0.2],   # near, fullscreen
        ])
        idx = jnp.asarray([[0, 1, 2], [3, 4, 5]], jnp.int32)
        vis = rasterize(clip, idx, width=64, height=64, use_pallas=False)
        assert np.all(np.asarray(vis.depth) < 0.21)
        # near triangle is clipped into candidates [1] (valid) + [3]
        # (invalid); the winner must resolve back to source triangle 1.
        src = np.asarray(vis.src)[np.asarray(vis.tri_id)]
        assert np.all(src == 1)

    def test_depth_leq_later_wins_on_tie(self):
        clip = ndc_tri_clip([
            [-1, -1, 0.5], [3, -1, 0.5], [-1, 3, 0.5],
            [-1, -1, 0.5], [3, -1, 0.5], [-1, 3, 0.5],
        ])
        idx = jnp.asarray([[0, 1, 2], [3, 4, 5]], jnp.int32)
        vis = rasterize(clip, idx, width=32, height=32, use_pallas=False)
        src = np.asarray(vis.src)[np.asarray(vis.tri_id)]
        assert np.all(src == 1)


class TestPallasKernel:
    def _random_soup(self, n_tri, seed=0, z_range=(0.05, 0.95)):
        rng = np.random.default_rng(seed)
        center = rng.uniform(-1.2, 1.2, (n_tri, 1, 2))
        offs = rng.uniform(-0.4, 0.4, (n_tri, 3, 2))
        z = rng.uniform(*z_range, (n_tri, 3, 1)).astype(np.float32)
        v = np.concatenate(
            [center + offs, z, np.ones((n_tri, 3, 1))], axis=-1
        ).astype(np.float32)
        clip = jnp.asarray(v.reshape(-1, 4))
        idx = jnp.arange(n_tri * 3, dtype=jnp.int32).reshape(n_tri, 3)
        return clip, idx

    @pytest.mark.parametrize("n_tri", [1, 7, 100])
    def test_matches_reference_oracle(self, n_tri):
        clip, idx = self._random_soup(n_tri)
        kw = dict(width=256, height=128)
        vis_ref = rasterize(clip, idx, use_pallas=False, **kw)
        vis_pal = rasterize(clip, idx, use_pallas=True, interpret=True, **kw)
        assert int(vis_pal.overflow) == 0
        np.testing.assert_array_equal(
            np.asarray(vis_ref.tri_id), np.asarray(vis_pal.tri_id)
        )
        np.testing.assert_allclose(
            np.asarray(vis_ref.depth), np.asarray(vis_pal.depth), atol=1e-6
        )

    def test_non_tile_aligned_size(self):
        clip, idx = self._random_soup(20, seed=3)
        vis_ref = rasterize(clip, idx, use_pallas=False, width=200, height=100)
        vis_pal = rasterize(clip, idx, use_pallas=True, interpret=True,
                            width=200, height=100)
        np.testing.assert_array_equal(
            np.asarray(vis_ref.tri_id), np.asarray(vis_pal.tri_id)
        )


class TestNearClip:
    def test_fully_behind_camera_dropped(self):
        clip = jnp.asarray(
            [[0, 0, -1, 1], [1, 0, -1, 1], [0, 1, -2, 1]], jnp.float32
        )
        _, _, _, valid = clip_near_triangles(
            clip, jnp.asarray([[0, 1, 2]], jnp.int32)
        )
        assert not bool(valid[0]) and not bool(valid[1])

    def test_fully_in_front_passthrough(self):
        clip = jnp.asarray(
            [[0, 0, 0.1, 1], [1, 0, 0.5, 1], [0, 1, 0.9, 1]], jnp.float32
        )
        corners, weights, src, valid = clip_near_triangles(
            clip, jnp.asarray([[0, 1, 2]], jnp.int32)
        )
        assert bool(valid[0]) and not bool(valid[1])
        np.testing.assert_allclose(
            np.asarray(corners[0]), np.asarray(clip), atol=1e-6
        )
        np.testing.assert_allclose(
            np.asarray(weights[0]), np.eye(3), atol=1e-6
        )

    def test_clipped_corners_land_on_near_plane(self):
        # One vertex behind z=0.
        clip = jnp.asarray(
            [[0, 0, 1.0, 2], [1, 0, -1.0, 2], [0, 1, 1.0, 2]], jnp.float32
        )
        corners, weights, src, valid = clip_near_triangles(
            clip, jnp.asarray([[0, 1, 2]], jnp.int32)
        )
        # 2 inside -> two output triangles, all corner z >= 0.
        assert bool(valid[0]) and bool(valid[1])
        z = np.asarray(corners)[np.asarray(valid)][..., 2]
        assert np.all(z >= -1e-6)
        # Every weights row is a convex combination.
        w = np.asarray(weights)
        assert np.allclose(w.sum(-1), 1.0, atol=1e-5)
        assert np.all(w >= -1e-6)

    def test_camera_inside_geometry_renders(self):
        # A big ground quad extending behind the camera.
        view = look_at([0, 1, 0], [0, 1, 5], [0, -1, 0])
        proj = perspective(np.radians(60), 1.0, 0.05, 80.0)
        world = np.array(
            [[-50, 0, -50, 1], [50, 0, -50, 1], [50, 0, 50, 1],
             [-50, 0, 50, 1]], np.float32,
        )
        clip = jnp.asarray(world @ (proj @ view).T)
        idx = jnp.asarray([[0, 1, 2], [0, 2, 3]], jnp.int32)
        vis = rasterize(clip, idx, width=128, height=128, use_pallas=False)
        tid = np.asarray(vis.tri_id)
        # The floor fills (roughly) the lower half of the screen.
        assert (tid[96:] >= 0).mean() > 0.95
        assert (tid[:32] >= 0).mean() < 0.05


class TestInterpolation:
    def test_perspective_correct_uv(self):
        # A floor quad in perspective: naive screen-space interpolation would
        # be visibly wrong; perspective-correct matches analytic projection.
        view = look_at([0, 1, -2], [0, 0, 2], [0, -1, 0])
        proj = perspective(np.radians(60), 1.0, 0.05, 80.0)
        world = np.array(
            [[-2, 0, 0, 1], [2, 0, 0, 1], [2, 0, 8, 1], [-2, 0, 8, 1]],
            np.float32,
        )
        uv = jnp.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], jnp.float32)
        clip = jnp.asarray(world @ (proj @ view).T)
        idx = jnp.asarray([[0, 1, 2], [0, 2, 3]], jnp.int32)
        W = H = 128
        vis = rasterize(clip, idx, width=W, height=H, use_pallas=False)
        bary, mask = pixel_barycentrics(vis.tri_id, vis.setup, W, H)
        cattr = corner_attributes(uv, idx, vis.weights, vis.src)
        uv_img = np.asarray(interpolate(cattr, vis.tri_id, bary))
        m = np.asarray(mask)

        # Check a covered pixel: reconstruct world pos from uv and reproject;
        # it must land back on the same pixel.
        ys, xs = np.nonzero(m)
        pick = slice(0, len(ys), max(1, len(ys) // 50))
        vp = np.asarray(proj @ view)
        for y, x in zip(ys[pick], xs[pick]):
            u, v = uv_img[y, x]
            world_pt = np.array(
                [-2 + 4 * u, 0, 8 * v, 1], np.float32
            )
            c = vp @ world_pt
            sx = (c[0] / c[3] * 0.5 + 0.5) * W
            sy = (c[1] / c[3] * 0.5 + 0.5) * H
            assert abs(sx - (x + 0.5)) < 0.25, (x, y, sx)
            assert abs(sy - (y + 0.5)) < 0.25, (x, y, sy)


class TestOverflow:
    """Bin-pair overflow must be reported, never silent (VisibilityBuffer
    .overflow / GBuffer.overflow; bench.py exits nonzero on drop)."""

    def _quad(self):
        clip = ndc_tri_clip(
            [[-1, -1, 0.5], [3, -1, 0.5], [-1, 3, 0.5]]
        )
        idx = jnp.asarray([[0, 1, 2]], jnp.int32)
        return clip, idx

    def test_healthy_run_reports_zero(self):
        clip, idx = self._quad()
        vis = rasterize(clip, idx, width=256, height=64,
                        use_pallas=True, interpret=True)
        assert int(vis.overflow) == 0

    def test_capacity_exceeded_is_counted(self):
        from vkr.raster.kernel import TILE_H, TILE_W

        clip, idx = self._quad()
        # A fullscreen triangle at 256x64 spans every tile; capacity 8
        # must report the rest as dropped (not silently lose geometry).
        vis = rasterize(clip, idx, width=256, height=64,
                        use_pallas=True, interpret=True, pair_capacity=8)
        n_tiles = (256 // TILE_W) * (64 // TILE_H)
        assert int(vis.overflow) == n_tiles - 8


def test_peel_requires_merged_kernel():
    """peel_depth is honoured by every raster route, with or without
    attributes: the tile walk must peel to the same layer as the oracle
    instead of silently rendering the first layer."""
    clip = ndc_tri_clip(np.array([
        [-0.5, -0.5, 0.3], [0.5, -0.5, 0.3], [0.0, 0.5, 0.3],   # front
        [-0.8, -0.8, 0.6], [0.8, -0.8, 0.6], [0.0, 0.8, 0.6],   # behind
    ]))
    idx = jnp.arange(6, dtype=jnp.int32).reshape(2, 3)
    kw = dict(width=64, height=32)
    first = rasterize(clip, idx, use_pallas=False, **kw)
    peeled_ref = rasterize(clip, idx, use_pallas=False,
                           peel_depth=first.depth, **kw)
    peeled = rasterize(clip, idx, use_pallas=True, interpret=True,
                       peel_depth=first.depth, **kw)
    src = np.asarray(peeled.src)
    front = np.asarray(first.tri_id) >= 0
    assert front.any()
    # under the front triangle only the back one survives the peel
    assert np.all(src[np.asarray(peeled.tri_id)[front]] == 1)
    np.testing.assert_array_equal(np.asarray(peeled_ref.tri_id),
                                  np.asarray(peeled.tri_id))
    np.testing.assert_array_equal(np.asarray(peeled_ref.depth),
                                  np.asarray(peeled.depth))


class TestBenchOrbitEnclosure:
    """The bench camera must stay inside the enclosed hall for ALL frames
    (caught live: the old 0.02*i orbit rate exited through the z=-6 wall
    at frame 10, collapsing coverage to 0.579 — the frame then showed the
    wall's exterior + background and the bench under-stated the workload).
    Renders the bench geometry LAYOUT (hall_l=60, walls at z=+-6, end
    caps) at tiny tessellation/res with bench.bench_orbit_view."""

    def test_orbit_frames_fully_covered(self):
        import jax

        from bench import BENCH_CENTER, BENCH_EYE, bench_orbit_view
        from vkr.config import RenderConfig
        from vkr.core import registry
        from vkr.frame import camera_frame
        from vkr.passes.gbuffer import upload_scene
        from vkr.scene.procedural import colonnade_scene

        width, height = 256, 128
        cfg = RenderConfig(width=width, height=height)
        scene = upload_scene(
            colonnade_scene(columns=24, tessellation=8, tex_size=32)
        )

        # Geometric guard first: the eye must stay strictly inside the
        # hall volume (|z| < 6, |x| < 60) for every bench frame.
        eye0 = np.array(BENCH_EYE, np.float32)
        center = np.array(BENCH_CENTER, np.float32)
        for i in range(16):
            view = np.asarray(bench_orbit_view(i))
            # look_at's camera position: solve R @ eye = -t
            rot, t = view[:3, :3], view[:3, 3]
            eye = -rot.T @ t
            assert abs(eye[2]) < 5.9, f"frame {i}: eye z={eye[2]}"
            assert abs(eye[0]) < 59.0, f"frame {i}: eye x={eye[0]}"

        jit_gbuf = jax.jit(lambda s, c: registry.get("gbuf_opaque_taa")(
            s, c.mvp, c.prev_mvp, c.jitter, width=width, height=height,
            quantize=False, use_pallas=True, interpret=True,
        ))
        for i in (1, 8, 15):  # early / mid / last bench frame
            cam = camera_frame(cfg, bench_orbit_view(i),
                               bench_orbit_view(i - 1), i)
            d = np.asarray(jit_gbuf(scene, cam).depth)
            cov = float(np.mean(d < 1.0))
            assert cov == 1.0, f"frame {i}: coverage {cov}"


class TestSoAFrontEnd:
    """The component-major (SoA) raster front end (setup.py 'SoA twins',
    the static-scene fast path) must match the row-major implementation
    given identical corner inputs. Bitwise equality holds in EAGER mode
    (reductions transcribed in the same order, _sum3 guarding FMA
    contraction) but not under jit — XLA fuses the two graph shapes
    differently and contracts different mul+add pairs into FMAs — so
    under jit the guarantee is ~1e-6 RELATIVE on every row column, and
    the integer binning outputs (bboxes, pair layout, segment table)
    must agree exactly on this seeded workload."""

    def test_bitwise_vs_rowmajor(self):
        import jax

        from vkr.raster import pair_rows as RR
        from vkr.raster import setup as RS
        from vkr.raster.resolve import corner_attributes_pre

        T = 1500
        k = jax.random.PRNGKey(7)
        clip = jax.random.normal(k, (T * 3, 4), jnp.float32) * 3
        clip = clip.at[:, 3].add(5.0)  # mostly in front, some clipped
        tri = clip.reshape(T, 3, 4)
        tri_t = tri.transpose(2, 1, 0).reshape(4, 3 * T)
        jit_ = jnp.asarray([0.001, -0.002], jnp.float32)
        attr = jax.random.normal(jax.random.PRNGKey(2), (T, 3, 9),
                                 jnp.float32)
        attr_t = attr.transpose(2, 1, 0).reshape(9, 3 * T)
        mat2 = jnp.concatenate([jnp.arange(T, dtype=jnp.int32) % 7] * 2)

        def rowmajor(tri):
            corners, weights, src, valid = RS.clip_near_corners(tri)
            s = RS.triangle_setup(corners, valid, 512, 256, jit_)
            cat = corner_attributes_pre(attr, weights)
            rows = RR.build_tri_rows(s, cat, mat2)
            bins = RS.bin_triangles(s, 512, 256, 8, 128, T * 3)
            return rows, bins

        def soa(tri_t):
            tri2, wt, valid = RS.clip_near_corners_t(tri_t, T)
            cc = RS._corners_from_weights_t(tri2, wt)
            st = RS.triangle_setup_t(cc, valid, 512, 256, jit_)
            cat = RR.corner_attributes_pre_t(attr_t, wt, T)
            rows = RR.build_tri_rows_t(st, cat, mat2)
            bins = RS.bin_triangles_t(st.bbox, st.valid, 512, 256, 8,
                                      128, T * 3)
            return rows, bins

        # eager: bitwise on the raster-critical columns (edges, depth
        # plane, ids, coverage box, denom, material) — no fusion-dependent
        # FMA contraction outside jit. The attribute-plane columns go
        # through einsum in the row-major path (a dot op with its own
        # accumulation) and are relative-tolerance everywhere.
        ro_e, bo_e = rowmajor(tri)
        rn_e, bn_e = soa(tri_t)
        ro_e = np.asarray(ro_e)
        rn_e = np.asarray(rn_e)
        planes = RR.RESOLVE_BASE + 3
        mat_col = RR.RESOLVE_BASE + 3 + 3 * RR.N_CHANNELS
        assert np.array_equal(ro_e[:, :planes], rn_e[:, :planes])
        assert np.array_equal(ro_e[:, mat_col], rn_e[:, mat_col])
        for x, y in zip(bo_e, bn_e):
            assert np.array_equal(np.asarray(x), np.asarray(y))

        # jit: per-column relative tolerance + exact integer binning
        ro = np.asarray(jax.jit(rowmajor)(tri)[0])
        rn, bn = jax.jit(soa)(tri_t)
        rn = np.asarray(rn)
        # FMA-contraction ulps are relative to the PRODUCT magnitudes
        # feeding each plane sum, which cancellation can amplify well
        # above the output scale — bound loosely per column; the eager
        # bitwise check above is the strict correctness gate.
        scale = np.abs(ro).max(0) + 1e-20
        rel = (np.abs(ro - rn) / scale).max()
        assert rel <= 1e-3, rel
        bo = jax.jit(rowmajor)(tri)[1]
        for x, y in zip(bo, bn):
            assert np.array_equal(np.asarray(x), np.asarray(y))


def _soup(n_tri, seed=0):
    return TestPallasKernel()._random_soup(n_tri, seed=seed)


def _prepared(clip, idx, width, height, **kw):
    vis = rasterize(clip, idx, width=width, height=height, use_pallas=True,
                    interpret=True, keep_prepared=True, **kw)
    return vis, vis.prepared


class TestTileKernelWrapper:
    """The tile walk's wrapper: tile padding, band row origin, peeling,
    the plain-XLA comparator and the attribute resolve."""

    def test_tile_padding_and_crop(self):
        from vkr.raster.kernel import TILE_H, TILE_W, raster_tiles

        clip, idx = _soup(20, seed=3)
        vis, prep = _prepared(clip, idx, 200, 100)
        assert vis.depth.shape == (100, 200)
        z, tid = raster_tiles(prep.pair_rows, prep.seg_starts,
                              prep.seg_counts, width=200, height=100,
                              interpret=True)
        assert z.shape == tid.shape == (-(-100 // TILE_H) * TILE_H,
                                        -(-200 // TILE_W) * TILE_W)
        np.testing.assert_array_equal(np.asarray(tid)[:100, :200],
                                      np.asarray(vis.tri_id))

    @pytest.mark.parametrize("row0", [0, 32])
    def test_row_offset_is_band_exact(self, row0):
        clip, idx = _soup(60, seed=5)
        H, W, bh = 96, 64, 32
        full = rasterize(clip, idx, width=W, height=H, use_pallas=True,
                         interpret=True)
        band = rasterize(clip, idx, width=W, height=bh, use_pallas=True,
                         interpret=True, full_height=H,
                         y_offset=jnp.int32(row0))
        np.testing.assert_array_equal(
            np.asarray(band.tri_id), np.asarray(full.tri_id)[row0:row0 + bh])
        np.testing.assert_array_equal(
            np.asarray(band.depth), np.asarray(full.depth)[row0:row0 + bh])

    def test_coverage_limited_to_the_bbox(self):
        """A pair whose edge functions hold everywhere covers only the
        pixel centres inside its box, whatever tile evaluates it."""
        from vkr.raster.kernel import RASTER_ROW, _cover

        row = np.zeros(RASTER_ROW, np.float32)
        row[6:9] = 1.0                 # e_i = 1: inside every edge
        row[11] = 0.5                  # depth 0.5 everywhere
        row[13:17] = [3.5, 5.5, 2.5, 4.5]   # pixels x 3..5, y 2..4
        ys, xs = np.mgrid[0:16, 0:16].astype(np.float32) + 0.5
        cover, _ = _cover(lambda k: row[k], jnp.asarray(xs),
                          jnp.asarray(ys), 1.0, -1.0)
        want = np.zeros((16, 16), bool)
        want[2:5, 3:6] = True
        np.testing.assert_array_equal(np.asarray(cover), want)

    @pytest.mark.parametrize("n_tri", [7, 100])
    def test_xla_comparator_matches_kernel(self, n_tri):
        from vkr.raster.kernel import raster_tiles_xla

        clip, idx = _soup(n_tri, seed=n_tri)
        vis, prep = _prepared(clip, idx, 96, 80)
        z, tid = raster_tiles_xla(prep.pair_rows, prep.seg_starts,
                                  prep.seg_counts, width=96, height=80)
        np.testing.assert_array_equal(np.asarray(tid)[:80, :96],
                                      np.asarray(vis.tri_id))
        np.testing.assert_array_equal(np.asarray(z)[:80, :96],
                                      np.asarray(vis.depth))

    def test_heavy_tile_split_matches_oracle(self):
        """A tile holding more than PAIRS_PER_ITEM pairs is walked by
        several programs and merged: still the oracle's visibility."""
        from vkr.raster.kernel import PAIRS_PER_ITEM, TILE_H, TILE_W

        n = 3 * PAIRS_PER_ITEM + 17
        rng = np.random.default_rng(23)
        W, H = 2 * TILE_W, 2 * TILE_H
        # small triangles crowded into the first tile (NDC of 0..TILE px)
        c = rng.uniform(-1.0, -1.0 + 2.0 * TILE_W / W, (n, 1, 2))
        v = np.concatenate(
            [c + rng.uniform(-0.05, 0.05, (n, 3, 2)),
             rng.uniform(0.1, 0.9, (n, 3, 1)), np.ones((n, 3, 1))],
            -1).astype(np.float32)
        clip = jnp.asarray(v.reshape(-1, 4))
        idx = jnp.arange(3 * n, dtype=jnp.int32).reshape(n, 3)
        ref = rasterize(clip, idx, width=W, height=H, use_pallas=False)
        vis, prep = _prepared(clip, idx, W, H)
        assert int(prep.seg_counts.max()) > 2 * PAIRS_PER_ITEM
        np.testing.assert_array_equal(np.asarray(vis.tri_id),
                                      np.asarray(ref.tri_id))
        np.testing.assert_allclose(np.asarray(vis.depth),
                                   np.asarray(ref.depth), atol=1e-6)

    def test_xla_comparator_honours_peel(self):
        from vkr.raster.kernel import raster_tiles, raster_tiles_xla

        clip, idx = _soup(80, seed=11)
        vis, prep = _prepared(clip, idx, 64, 48)
        args = (prep.pair_rows, prep.seg_starts, prep.seg_counts,
                vis.depth)
        zk, tk = raster_tiles(*args, width=64, height=48, interpret=True)
        zx, tx = raster_tiles_xla(*args, width=64, height=48)
        np.testing.assert_array_equal(np.asarray(tk), np.asarray(tx))
        np.testing.assert_array_equal(np.asarray(zk), np.asarray(zx))
        # peeling moved some pixels to a farther layer
        assert (np.asarray(zk)[:48, :64] > np.asarray(vis.depth)).any()

    def test_resolved_attributes_match_oracle(self):
        """Plane replay of the winner's row (tile route) vs barycentric
        interpolation (oracle route): perspective-correct attributes
        agree to float rounding wherever both pick the same triangle."""
        clip, idx = _soup(40, seed=13)
        rng = np.random.default_rng(14)
        attrs = jnp.asarray(rng.normal(size=(clip.shape[0], 9)),
                            jnp.float32)
        mat = jnp.arange(idx.shape[0], dtype=jnp.int32) % 5
        kw = dict(width=64, height=64, vertex_attrs=attrs, tri_mat=mat)
        ref = rasterize(clip, idx, use_pallas=False, **kw)
        ker = rasterize(clip, idx, use_pallas=True, interpret=True, **kw)
        same = np.asarray(ref.tri_id) == np.asarray(ker.tri_id)
        assert same.mean() > 0.999
        fg = same & (np.asarray(ref.tri_id) >= 0)
        a, b = np.asarray(ref.resolved)[fg], np.asarray(ker.resolved)[fg]
        np.testing.assert_array_equal(a[:, 9], b[:, 9])  # material id
        np.testing.assert_allclose(a[:, :9], b[:, :9], rtol=1e-3,
                                   atol=1e-3)
        bg = np.asarray(ker.tri_id) < 0
        assert bg.any()
        assert np.all(np.asarray(ker.resolved)[bg][:, :9] == 0.0)
        assert np.all(np.asarray(ker.resolved)[bg][:, 9] == -1.0)


@pytest.mark.gpu
def test_compiled_tile_kernel_matches_xla(gpu_device):
    """The compiled Triton tile walk vs the plain-XLA comparator (chip
    check; chip_smoke.py runs the same comparison at bench size)."""
    from vkr.raster.kernel import raster_tiles, raster_tiles_xla

    clip, idx = _soup(500, seed=21)
    vis, prep = _prepared(clip, idx, 256, 128)
    args = (prep.pair_rows, prep.seg_starts, prep.seg_counts)
    zk, tk = raster_tiles(*args, width=256, height=128)
    zx, tx = raster_tiles_xla(*args, width=256, height=128)
    assert (np.asarray(tk) == np.asarray(tx)).mean() >= 0.9999
