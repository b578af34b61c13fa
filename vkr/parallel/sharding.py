"""Multi-device rendering via jax.sharding + shard_map.

The reference is strictly single-GPU (SURVEY.md §2.5) — multi-device is an
extension of this port, not a translation. Two natural decompositions
for a renderer:

  * view parallelism (implemented): a batch of cameras — probe cubemap
    faces, probe-grid entries, stereo eyes, jitter phases — rendered one
    per device with the scene replicated. The natural fit for the probe
    renderer (probe_renderer.cpp renders 6 cube faces x grid^2 probes —
    an embarrassingly view-parallel bake). Outputs are device-sharded on
    the view axis; any cross-view reduction (e.g. probe SH projection)
    rides the interconnect via psum.

  * pixel-band parallelism (parallel/band.py): shard the pixel grid rows
    across devices with band-exact viewports.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P


def make_render_mesh(n_devices: Optional[int] = None,
                     axis: str = "views") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def render_views_sharded(
    scene,
    states,        # FrameState pytree batched on axis 0: (V, ...)
    cams,          # CameraFrame pytree batched on axis 0: (V, ...)
    ssr_res,
    cfg,
    mesh: Mesh,
    *,
    use_pallas: bool = True,
    interpret: bool = False,
):
    """Render V views, one per device in `mesh` (V == mesh size).

    Returns (colors (V, H, W, 3), new states batched) with outputs sharded
    over the view axis. Scene and LUTs are replicated.
    """
    from vkr.frame import render_frame

    axis = mesh.axis_names[0]

    def per_device(scene_in, state_b, cam_b, ssr_in):
        # Each device holds a (1, ...) slice of the view batch.
        state = jax.tree_util.tree_map(lambda x: x[0], state_b)
        cam = jax.tree_util.tree_map(lambda x: x[0], cam_b)
        color, new_state, _aux = render_frame(
            scene_in, state, cam, ssr_in, cfg,
            use_pallas=use_pallas, interpret=interpret,
        )
        new_state_b = jax.tree_util.tree_map(
            lambda x: jnp.asarray(x)[None], new_state
        )
        return color[None], new_state_b

    fn = shard_map(
        per_device,
        mesh=mesh,
        in_specs=(P(), P(axis), P(axis), P()),
        out_specs=(P(axis), P(axis)),
        check_vma=False,
    )
    return fn(scene, states, cams, ssr_res)


def batch_states(make_state, n: int):
    """Stack n fresh FrameStates on a new leading axis."""
    states = [make_state() for _ in range(n)]
    return jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs, axis=0), *states
    )


def batch_cams(cams):
    return jax.tree_util.tree_map(
        lambda *xs: jnp.stack([jnp.asarray(x) for x in xs], axis=0), *cams
    )
