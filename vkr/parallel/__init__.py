from vkr.parallel.sharding import (
    make_render_mesh,
    render_views_sharded,
)
from vkr.parallel.band import render_frame_banded  # noqa: F401
