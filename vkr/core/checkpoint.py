"""FrameState checkpoint/resume.

The reference serializes no state (SURVEY.md §5.4) — its only persistence
is debug captures. As a framework extension, the temporal history pytree
(FrameState) can be saved/restored so a session (TAA/GTAO/SSR convergence)
survives process restarts — the renderer-shaped analog of training
checkpoint/resume.
"""

from __future__ import annotations

import os

import numpy as np

from vkr.core.framestate import FrameState


def save_state(state: FrameState, path: str) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(
        path,
        **{name: np.asarray(getattr(state, name))
           for name in FrameState.FIELDS},
    )
    return path


def load_state(path: str) -> FrameState:
    import jax.numpy as jnp

    with np.load(path) as data:
        return FrameState(
            **{name: jnp.asarray(data[name]) for name in FrameState.FIELDS}
        )
