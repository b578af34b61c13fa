"""Test configuration: by default run everything on a virtual 8-device
CPU mesh, with Pallas kernels in interpret mode. On a GPU machine the
card-only checks run with `JAX_PLATFORMS=cuda python -m pytest tests/ -m
gpu`.

The environment must be set before JAX initializes (__graft_entry__.py
dry-runs the multi-device path the same way).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

# Persistent compilation cache (JAX_COMPILATION_CACHE_DIR, else the fixed
# in-checkout directory): interpret-mode Pallas renders dominate the
# suite's runtime and their compiles are the cost.
from vkr.core.platform import configure_compile_cache

configure_compile_cache()


# ---- slow-test opt-in (default run stays under the ~15-min bar) ----
# The multi-minute tail is a handful of FULL-frame interpret-mode
# renders (band-sharded frames, the textured golden, probe-GI frame).
# They are marked @pytest.mark.slow and SKIPPED by default; run the
# whole suite with:  python -m pytest tests/ --runslow
import pytest  # noqa: E402


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="also run tests marked slow (multi-minute full-frame "
             "interpret renders)",
    )


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: multi-minute full-frame interpret render; "
        "excluded unless --runslow")
    config.addinivalue_line(
        "markers", "gpu: needs a GPU (compiled Triton kernels); skips on "
        "the CPU. chip_smoke.py runs the same checks on the card")


@pytest.fixture
def gpu_device():
    """Skip unless JAX has a GPU. Decided at test time, never at import:
    every xdist worker must collect the same tests."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        pytest.skip("needs a GPU (compiled Triton kernel); chip_smoke.py "
                    "runs this check on the card")
    return devs[0]


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    skip = pytest.mark.skip(reason="slow: use --runslow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
