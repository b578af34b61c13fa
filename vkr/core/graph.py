"""Pass-DAG orchestration — the rendergraph analog.

The reference rendergraph (src/rendergraph/rendergraph.{hpp,cpp}) exists to
compute barriers/layouts between tasks recorded into one command buffer.
Here the whole frame is a pure function traced once under jax.jit: XLA's
dataflow *is* the schedule, so the barrier engine dissolves (SURVEY.md §5.8).

What survives here:
  * task naming — each pass runs under jax.named_scope with the reference's
    task name (GbufferPass, SSSR_trace, GTAO_main, ...) so profiles line up
    1:1 with the reference's debug labels (rendergraph.cpp:289-305);
  * the structural dump — the analog of the reference's barrier printer
    (resources.cpp:483-634) is a pass-DAG record that can be printed for
    inspection / golden tests;
  * per-pass timing via jax.block_until_ready on intermediate outputs when
    profiling mode is on (outside jit).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import jax


@dataclasses.dataclass
class PassRecord:
    name: str
    inputs: List[str]
    outputs: List[str]


def _describe(tree: Any) -> List[str]:
    out = []
    for leaf in jax.tree_util.tree_leaves(tree):
        shape = getattr(leaf, "shape", ())
        dtype = getattr(leaf, "dtype", type(leaf).__name__)
        out.append(f"{dtype}{list(shape)}")
    return out


class PassGraph:
    """Records the pass structure of a frame while the frame fn is traced.

    Usage:
        graph = PassGraph()
        with graph.recording():
            out = frame_fn(...)   # passes call graph.add_task(...)
        print(graph.dump())
    """

    _active: Optional["PassGraph"] = None

    def __init__(self) -> None:
        self.records: List[PassRecord] = []

    @contextlib.contextmanager
    def recording(self):
        prev, PassGraph._active = PassGraph._active, self
        try:
            yield self
        finally:
            PassGraph._active = prev

    def dump(self) -> str:
        """Human-readable DAG dump (analog of the reference's barrier dump,
        printed for the first frames at rendergraph.cpp:272-280)."""
        lines = ["=== pass DAG ==="]
        for i, r in enumerate(self.records):
            lines.append(f"[{i:2d}] {r.name}")
            lines.append(f"      in : {', '.join(r.inputs) or '-'}")
            lines.append(f"      out: {', '.join(r.outputs) or '-'}")
        return "\n".join(lines)


def add_task(name: str, fn: Callable, *args: Any, **kwargs: Any):
    """Run `fn` under a named scope, recording it if a PassGraph is active.

    The JAX analog of RenderGraph::add_task (rendergraph.hpp:116-128): there
    is no declare/execute split because there are no barriers to compute —
    the declared accesses are simply the function arguments and returns.
    """
    with jax.named_scope(name):
        out = fn(*args, **kwargs)
    graph = PassGraph._active
    if graph is not None:
        graph.records.append(
            PassRecord(name, _describe((args, kwargs)), _describe(out))
        )
    return out


class PassProfiler:
    """Per-pass wall-clock timing (outside jit): runs each pass eagerly and
    blocks on its outputs. The analog of reading per-task debug labels in a
    RenderDoc capture (SURVEY.md §5.1)."""

    def __init__(self) -> None:
        self.times_ms: Dict[str, float] = {}

    def run(self, name: str, fn: Callable, *args, **kwargs):
        jax.block_until_ready(jax.tree_util.tree_leaves((args, kwargs)))
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        jax.block_until_ready(out)
        self.times_ms[name] = self.times_ms.get(name, 0.0) + (
            time.perf_counter() - t0
        ) * 1e3
        return out

    def report(self) -> str:
        total = sum(self.times_ms.values())
        lines = [f"{'pass':<24} ms"]
        for name, ms in self.times_ms.items():
            lines.append(f"{name:<24} {ms:7.3f}")
        lines.append(f"{'TOTAL':<24} {total:7.3f}")
        return "\n".join(lines)
