"""Backend selection: which device JAX runs on, how Pallas kernels are
compiled for it, and where compiled programs are cached.

Every entry point calls `ensure_platform()` before it touches JAX and asks
`pallas_interpret()` whether its Pallas calls run compiled or in the
interpreter. There is one route per backend:

  gpu  -> compiled Pallas kernels through Triton
  cpu  -> interpret mode, only when the caller asked for the CPU
          (JAX_PLATFORMS / VKR_PLATFORM / the `platform` argument)
  else -> an error: no kernel route exists for that backend
"""

from __future__ import annotations

import os
from pathlib import Path

# One fixed, checkout-relative compile-cache directory (the directory is
# part of the cache key, so it must not move between runs).
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"

KERNEL_ROUTES = {"gpu": "triton", "cpu": "interpret"}


def _requested_platforms(platform: str | None = None) -> str:
    return (platform or os.environ.get("VKR_PLATFORM")
            or os.environ.get("JAX_PLATFORMS") or "")


def configure_compile_cache() -> str:
    """Persistent compile cache. JAX_COMPILATION_CACHE_DIR, when set, is
    used as is (JAX reads it itself); otherwise the fixed in-checkout
    DEFAULT_CACHE_DIR. Returns the directory in use."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return str(DEFAULT_CACHE_DIR)


def ensure_platform(platform: str | None = None) -> str:
    """Pin the JAX backend (explicit arg > VKR_PLATFORM > JAX_PLATFORMS >
    JAX's own choice), configure the compile cache and return the
    backend name."""
    import jax

    want = _requested_platforms(platform)
    if want:
        jax.config.update("jax_platforms", want)
    configure_compile_cache()
    return jax.default_backend()


def kernel_route(backend: str | None = None,
                 platform: str | None = None) -> str:
    """The Pallas route for `backend` (default: JAX's current backend):
    "triton" on the GPU, "interpret" on a CPU the caller asked for.
    Raises RuntimeError when no route exists, including a CPU that JAX
    fell back to without being asked."""
    import jax

    backend = backend or jax.default_backend()
    route = KERNEL_ROUTES.get(backend)
    if route is None:
        raise RuntimeError(
            f"no Pallas kernel route for backend {backend!r} "
            f"(supported: {sorted(KERNEL_ROUTES)})")
    if backend == "cpu" and "cpu" not in _requested_platforms(platform):
        raise RuntimeError(
            "JAX found no GPU and fell back to the CPU; set "
            "JAX_PLATFORMS=cpu to run the kernels in interpret mode")
    return route


def pallas_interpret(backend: str | None = None,
                     platform: str | None = None) -> bool:
    """True when Pallas calls must run in interpret mode (CPU route)."""
    return kernel_route(backend, platform) == "interpret"


def require_gpu() -> None:
    """Measurement entry points (bench.py, chip_smoke.py) run on the GPU
    or not at all: they never fall back to the CPU."""
    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise SystemExit(
            f"error: this measurement needs a GPU; JAX found "
            f"{platform!r}")
