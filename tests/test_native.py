"""Native C++ asset pipeline vs numpy equivalence."""

import subprocess
import os

import numpy as np
import pytest

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "vkr", "native")


@pytest.fixture(scope="module", autouse=True)
def build_native():
    subprocess.run(["make", "-C", NATIVE_DIR], check=True,
                   capture_output=True)
    from vkr import native

    native._lib = None  # force reload after build
    assert native.available()


def test_mip_downsample_matches_numpy():
    from vkr import native

    rng = np.random.default_rng(0)
    src = rng.integers(0, 256, (3, 16, 16, 4), np.uint8)
    got = native.mip_downsample_rgba8(src)
    want = (
        (src.astype(np.uint16)
         .reshape(3, 8, 2, 8, 2, 4).sum(axis=(2, 4)) + 2) // 4
    ).astype(np.uint8)
    np.testing.assert_array_equal(got, want)


def test_full_pyramid_via_native():
    from vkr.scene.scene import build_mip_pyramid

    rng = np.random.default_rng(1)
    tex = rng.integers(0, 256, (2, 32, 32, 4), np.uint8)
    mips = build_mip_pyramid(tex)
    assert [m.shape[1] for m in mips] == [32, 16, 8, 4, 2, 1]


def test_resize_identity_and_downscale():
    from vkr import native

    rng = np.random.default_rng(2)
    src = rng.integers(0, 256, (16, 16, 4), np.uint8)
    up = native.resize_rgba8(src, 16, 16)
    np.testing.assert_array_equal(up, src)  # identity resize is exact
    down = native.resize_rgba8(src, 8, 8)
    want = (
        (src.astype(np.uint16).reshape(8, 2, 8, 2, 4).sum(axis=(1, 3)))
        / 4.0
    )
    assert np.abs(down.astype(float) - want).max() <= 1.0


def test_transform_points():
    from vkr import native

    rng = np.random.default_rng(3)
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = [1, 2, 3]
    pts = rng.normal(size=(100, 3)).astype(np.float32)
    got = native.transform_points(m, pts)
    np.testing.assert_allclose(got, pts + np.asarray([1, 2, 3]),
                               rtol=1e-6)
