"""Render passes — the analog of the reference's pass layer (src/*.cpp)
plus its shader manifest: importing this package registers every pass
entry point in vkr.core.registry under the reference's
src/shaders/config.json program names (loaded at startup there,
main.cpp:178-215)."""

from vkr.passes import (  # noqa: F401
    downsample,
    gbuffer,
    gtao,
    probes,
    sampling,
    screen_trace,
    shading,
    shadows,
    simple_ssr,
    ssao,
    ssr,
    ssr_tiles,
    taa,
    trace_samples,
    util_passes,
)
