"""Property tests for the math layer: encode/decode round trips and GLM
convention parity (SURVEY.md §4 rebuild implication — the reference has no
tests; octahedral round-trip is called out explicitly)."""

import numpy as np
import jax.numpy as jnp
import pytest

from vkr.mathlib import (
    decode_normal,
    encode_depth,
    encode_normal,
    linearize_depth,
    look_at,
    perspective_vk,
    project_view_vec,
    reconstruct_view_vec,
    taa_jitter_sequence,
)
from vkr.mathlib.brdf import (
    brdf_g2,
    distribution_ggx,
    fresnel_schlick,
    halton23_table,
    sample_ggx_vndf,
)


def random_unit_vectors(n, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


class TestOctahedral:
    def test_round_trip(self):
        v = random_unit_vectors(4096)
        dec = np.asarray(decode_normal(encode_normal(jnp.asarray(v))))
        assert np.max(np.abs(dec - v)) < 1e-5

    def test_round_trip_quantized_16bit(self):
        # RG16_UNORM storage (scene_renderer.cpp:16) keeps normals accurate.
        v = random_unit_vectors(4096, seed=1)
        uv = np.asarray(encode_normal(jnp.asarray(v)))
        uv_q = np.round(uv * 65535.0) / 65535.0
        dec = np.asarray(decode_normal(jnp.asarray(uv_q)))
        dots = np.sum(dec * v, axis=-1)
        assert np.min(dots) > 1.0 - 1e-6

    def test_axis_vectors(self):
        axes = np.array(
            [[1, 0, 0], [0, 1, 0], [0, 0, 1], [-1, 0, 0], [0, -1, 0], [0, 0, -1]],
            np.float32,
        )
        dec = np.asarray(decode_normal(encode_normal(jnp.asarray(axes))))
        assert np.allclose(dec, axes, atol=1e-6)


class TestDepth:
    def test_encode_linearize_round_trip(self):
        znear, zfar = 0.05, 80.0
        z = -np.linspace(znear * 1.01, zfar * 0.99, 1000).astype(np.float32)
        d = np.asarray(encode_depth(jnp.asarray(z), znear, zfar))
        assert np.all(d >= -1e-5) and np.all(d <= 1.0 + 1e-5)
        z2 = np.asarray(linearize_depth(jnp.asarray(d), znear, zfar))
        # f32 reciprocal depth loses relative precision toward the far
        # plane (same physics as hardware D24); 5e-4 relative is expected.
        assert np.max(np.abs(z2 - z) / np.abs(z)) < 5e-4

    def test_projection_matrix_consistency(self):
        """encode_depth must agree with the perspective matrix's depth."""
        znear, zfar = 0.05, 80.0
        proj = perspective_vk(np.radians(60.0), 16 / 9, znear, zfar)
        z = -5.0
        clip = proj @ np.array([0.3, -0.2, z, 1.0], np.float32)
        d_matrix = clip[2] / clip[3]
        d_formula = float(encode_depth(jnp.asarray(z), znear, zfar))
        assert abs(d_matrix - d_formula) < 1e-6

    def test_near_far_map_to_0_1(self):
        znear, zfar = 0.05, 80.0
        proj = perspective_vk(np.radians(60.0), 1.0, znear, zfar)
        for z, expect in [(-znear, 0.0), (-zfar, 1.0)]:
            clip = proj @ np.array([0, 0, z, 1.0], np.float32)
            assert abs(clip[2] / clip[3] - expect) < 1e-5


class TestReconstruction:
    def test_project_reconstruct_round_trip(self):
        fovy, aspect, znear, zfar = np.radians(60.0), 16 / 9, 0.05, 80.0
        rng = np.random.default_rng(2)
        v = np.stack(
            [
                rng.uniform(-3, 3, 500),
                rng.uniform(-3, 3, 500),
                -rng.uniform(0.1, 70, 500),
            ],
            axis=-1,
        ).astype(np.float32)
        uvd = np.asarray(project_view_vec(jnp.asarray(v), fovy, aspect, znear, zfar))
        back = np.asarray(
            reconstruct_view_vec(
                jnp.asarray(uvd[..., :2]), jnp.asarray(uvd[..., 2]),
                fovy, aspect, znear, zfar,
            )
        )
        rel = np.abs(back - v) / (np.abs(v) + 1.0)
        assert np.max(rel) < 1e-3

    def test_reconstruct_matches_inverse_projection(self):
        """reconstruct_view_vec must invert the actual raster projection."""
        fovy, aspect, znear, zfar = np.radians(60.0), 1.0, 0.05, 80.0
        proj = perspective_vk(fovy, aspect, znear, zfar)
        view_pos = np.array([1.0, -2.0, -10.0, 1.0], np.float32)
        clip = proj @ view_pos
        ndc = clip[:3] / clip[3]
        uv = 0.5 * ndc[:2] + 0.5
        rec = np.asarray(
            reconstruct_view_vec(jnp.asarray(uv), jnp.asarray(ndc[2]),
                                 fovy, aspect, znear, zfar)
        )
        assert np.allclose(rec, view_pos[:3], atol=1e-3)


class TestCamera:
    def test_look_at_maps_eye_to_origin(self):
        view = look_at([1, 2, 3], [4, 5, 6], [0, -1, 0])
        p = view @ np.array([1, 2, 3, 1], np.float32)
        assert np.allclose(p[:3], 0, atol=1e-6)

    def test_look_at_forward_is_minus_z(self):
        eye = np.array([0, 1, -1], np.float32)
        center = np.array([0, 1, 1], np.float32)
        view = look_at(eye, center, [0, -1, 0])
        p = view @ np.array([0, 1, 1, 1], np.float32)
        assert p[2] < 0 and abs(p[0]) < 1e-6 and abs(p[1]) < 1e-6

    def test_jitter_sequence(self):
        seq = taa_jitter_sequence(512, 512)
        assert seq.shape == (4, 2)
        assert np.allclose(np.abs(seq), 0.5 / 512, atol=1e-7)


class TestBRDF:
    def test_ndf_normalization(self):
        """Integral of D(h) * cos(theta_h) over the hemisphere == 1."""
        alpha = 0.5
        n = 512
        theta = (np.arange(n) + 0.5) * (np.pi / 2) / n
        d = np.asarray(distribution_ggx(jnp.asarray(np.cos(theta)), alpha))
        integral = np.sum(
            d * np.cos(theta) * np.sin(theta) * (np.pi / 2 / n)
        ) * 2 * np.pi
        assert abs(integral - 1.0) < 1e-2

    def test_fresnel_limits(self):
        f0 = jnp.asarray([0.04, 0.04, 0.04])
        at0 = np.asarray(fresnel_schlick(jnp.asarray(1.0), f0))
        at90 = np.asarray(fresnel_schlick(jnp.asarray(0.0), f0))
        assert np.allclose(at0, 0.04, atol=1e-6)
        assert np.allclose(at90, 1.0, atol=1e-6)

    def test_g2_bounds(self):
        rng = np.random.default_rng(3)
        ndv = jnp.asarray(rng.uniform(0.01, 1, 100).astype(np.float32))
        ndl = jnp.asarray(rng.uniform(0.01, 1, 100).astype(np.float32))
        g = np.asarray(brdf_g2(ndv, ndl, 0.25))
        assert np.all(g > 0) and np.all(g <= 1.0 + 1e-6)

    def test_vndf_returns_unit_upper_hemisphere(self):
        rng = np.random.default_rng(4)
        ve = random_unit_vectors(256, seed=5)
        ve[:, 2] = np.abs(ve[:, 2])  # view in upper hemisphere
        ve /= np.linalg.norm(ve, axis=-1, keepdims=True)
        u1 = rng.uniform(0, 1, 256).astype(np.float32)
        u2 = rng.uniform(0, 1, 256).astype(np.float32)
        ne = np.asarray(
            sample_ggx_vndf(jnp.asarray(ve), 0.3, 0.3,
                            jnp.asarray(u1), jnp.asarray(u2))
        )
        assert np.allclose(np.linalg.norm(ne, axis=-1), 1.0, atol=1e-5)
        assert np.all(ne[:, 2] >= -1e-6)

    def test_halton(self):
        t = halton23_table(64)
        assert t.shape == (64, 2)
        assert t[0, 0] == 0.5 and abs(t[0, 1] - 1 / 3) < 1e-6
        assert np.all((t > 0) & (t < 1))


class TestFormats:
    def test_unorm_round_trip(self):
        from vkr.core.formats import quantize_unorm

        x = jnp.linspace(0, 1, 257)
        q = np.asarray(quantize_unorm(x, 8))
        assert np.max(np.abs(q - np.asarray(x))) <= 0.5 / 255 + 1e-6

    def test_srgb_round_trip(self):
        from vkr.core.formats import linear_to_srgb, srgb_to_linear

        x = jnp.linspace(0, 1, 100)
        back = np.asarray(srgb_to_linear(linear_to_srgb(x)))
        assert np.max(np.abs(back - np.asarray(x))) < 1e-5

    def test_d24_on_power_of_two_grid(self):
        from vkr.core.formats import quantize_d24

        x = jnp.asarray(np.random.default_rng(0).random(4096), jnp.float32)
        q = np.asarray(quantize_d24(x), np.float64)
        k = q * 2.0 ** 24
        np.testing.assert_array_equal(k, np.round(k))
        # within 6e-8 of the D24 UNORM value k / (2^24 - 1)
        assert np.abs(k / (2.0 ** 24 - 1) - q).max() < 6e-8
        np.testing.assert_array_equal(np.asarray(quantize_d24(q)), q)

    def test_d24_subtraction_is_the_same_fused_or_not(self):
        """A consumer that subtracts the quantized depth gets the same
        value whether the quantization is fused into it or read back."""
        import jax

        from vkr.core.formats import quantize_d24

        rng = np.random.default_rng(1)
        d = jnp.asarray(rng.uniform(0.01, 1.0, 4096), jnp.float32)
        x = jnp.asarray(rng.uniform(0.01, 1.0, 4096), jnp.float32)
        q = np.asarray(quantize_d24(d))
        fused = np.asarray(jax.jit(lambda d, x: x - quantize_d24(d))(d, x))
        np.testing.assert_array_equal(fused, np.asarray(x) - q)

