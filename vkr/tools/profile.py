"""Device-time profile of the frame, pass by pass, from a jax.profiler
trace (the RenderDoc-label analog, SURVEY.md §5.1).

Every pass runs under an `add_task` named scope (core/graph.py), which XLA
keeps in each HLO instruction's `op_name` metadata. `device_times` traces
a few steps of a jitted function, maps each GPU kernel event back to its
HLO instruction and from there to the outermost pass scope, and sums the
device durations per pass. Device busy time is the union of the kernel
intervals; the idle share is 1 - busy / window.

    python -m vkr.tools.profile --scene sponza --frames 4
    python -m vkr.tools.profile --plain   # kernels -> their XLA twins
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import re
import tempfile

_INSTR = re.compile(r'^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?op_name="([^"]*)"')
# a Pallas kernel's launch name, as its custom call's backend config
# carries it (the trace names the kernel event after it)
_KERNEL = re.compile(r'\bname\\?"?\s*[:=]\s*\\?"([\w.\-]+)')


def scope_of(op_name: str, scopes):
    """The outermost pass scope on an op_name path, or None."""
    for part in op_name.split("/"):
        if part in scopes:
            return part
    return None


def hlo_scopes(hlo_text: str, scopes) -> dict:
    """{HLO instruction name or Pallas kernel name: outermost pass scope
    in its op_name}."""
    out = {}
    for line in hlo_text.splitlines():
        m = _INSTR.match(line)
        if not m:
            continue
        scope = scope_of(m.group(2), scopes)
        if scope is None:
            continue
        out[m.group(1)] = scope
        k = _KERNEL.search(line)
        if k and "custom_call_target" in line:
            out[k.group(1)] = scope
    return out


def kernel_names(hlo_text: str) -> list:
    """The launch names of the Pallas kernels a compiled program calls."""
    names = []
    for line in hlo_text.splitlines():
        k = _KERNEL.search(line)
        if k and "custom_call_target" in line:
            names.append(k.group(1))
    return names


def pass_names(fn, *args) -> list:
    """The add_task names `fn` records while tracing."""
    import jax

    from vkr.core.graph import PassGraph

    graph = PassGraph()
    with graph.recording():
        jax.eval_shape(fn, *args)
    return [r.name for r in graph.records]


def _stat(event, name):
    for k, v in event.stats:
        if k == name:
            return v
    return None


def event_scope(ev, op_scope: dict, scopes):
    """The pass scope of one device event: its own op_name ('name' stat),
    else its HLO instruction (the 'hlo_op' stat, or the kernel name,
    which XLA derives from the instruction: "fusion_3" for "fusion.3";
    Pallas kernels are named after the launch, "raster_tiles__2")."""
    scope = scope_of(_stat(ev, "name") or "", scopes)
    if scope is not None:
        return scope
    for key in (_stat(ev, "hlo_op"), ev.name,
                re.sub(r"_(\d+)$", r".\1", ev.name),
                re.sub(r"__\d+$", "", ev.name)):
        if key in op_scope:
            return op_scope[key]
    return None


def reduce_trace(path: str, op_scope: dict, steps: int,
                 scopes=()) -> dict:
    """Per-step device ms by pass scope from one .xplane.pb file, plus
    busy/window/idle share over the traced window (event_scope)."""
    from jax.profiler import ProfileData

    data = ProfileData.from_file(path)
    scopes = set(scopes) or set(op_scope.values())
    per_scope = collections.Counter()
    per_kernel = collections.Counter()
    other = collections.Counter()
    intervals = []
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                scope = event_scope(ev, op_scope, scopes)
                if scope is None:
                    scope = "(other)"
                    other[f"{ev.name} [{_stat(ev, 'hlo_op')}]"] += \
                        ev.duration_ns
                per_scope[scope] += ev.duration_ns
                per_kernel[ev.name] += ev.duration_ns
                intervals.append((ev.start_ns, ev.end_ns))
    if not intervals:
        raise RuntimeError(f"no GPU device events in {path}")
    intervals.sort()
    busy, cur_s, cur_e = 0, *intervals[0]
    for s, e in intervals[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = intervals[-1][1] - intervals[0][0]
    ms = 1e-6 / steps
    return {
        "pass_ms": {k: v * ms for k, v in per_scope.most_common()},
        "kernel_ms": {k: v * ms for k, v in per_kernel.most_common(25)},
        "other_ms": {k: v * ms for k, v in other.most_common(10)},
        "busy_ms": busy * ms,
        "window_ms": window * ms,
        "idle_share": 1.0 - busy / window,
    }


def device_times(jitted, args, steps: int = 4, scopes=(), logdir=None,
                 absent=()):
    """Trace `steps` calls of the jitted function `jitted(*args)` (already
    compiled) and reduce them (reduce_trace). scopes: the pass names to
    attribute to (pass_names); absent: kernel names the compiled program
    must not contain (the check that a route swap took effect)."""
    import jax

    text = jitted.lower(*args).compile().as_text()
    found = set(absent) & set(kernel_names(text))
    if found:
        raise RuntimeError(f"compiled frame still calls {found}")
    op_scope = hlo_scopes(text, set(scopes))
    jax.block_until_ready(jitted(*args))
    logdir = logdir or tempfile.mkdtemp(prefix="vkr_trace_")
    with jax.profiler.trace(logdir):
        for _ in range(steps):
            out = jitted(*args)
        jax.block_until_ready(out)
    [path] = glob.glob(f"{logdir}/**/*.xplane.pb", recursive=True)
    return reduce_trace(path, op_scope, steps, scopes)


TWIN_KERNELS = ("raster_tiles", "ssr_march")


def use_plain_twins():
    """Route the frame's two hand-written kernels to their plain-XLA
    twins for this process (tile raster -> raster_tiles_xla, SSR march ->
    march_plain): the end-to-end comparison each kernel must win. The
    frame looks both up as module attributes when it is traced; main()
    checks that neither kernel (TWIN_KERNELS) is left in the compiled
    program."""
    from vkr.passes import ssr, ssr_march
    from vkr.raster import kernel

    def raster(*args, interpret=False, **kw):
        return kernel.raster_tiles_xla(*args, **kw)

    def march(*args, interpret=False, **kw):
        return ssr_march.march_plain(*args, **kw)

    kernel.raster_tiles = raster
    ssr.march_kernel = march


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--scene", default="sponza")
    parser.add_argument("--width", type=int, default=1920)
    parser.add_argument("--height", type=int, default=1080)
    parser.add_argument("--tex-size", type=int, default=1024)
    parser.add_argument("--frames", type=int, default=4)
    parser.add_argument("--plain", action="store_true",
                        help="replace the two kernels by their XLA twins")
    parser.add_argument("--out", default=None, help="JSON result path")
    args = parser.parse_args(argv)

    from vkr.core.platform import ensure_platform, pallas_interpret

    ensure_platform()
    import jax

    from vkr.config import RenderConfig
    from vkr.core.framestate import FrameState
    from vkr.frame import (build_ssr_resources, camera_frame,
                               render_frame)
    from vkr.mathlib import look_at
    from vkr.passes.gbuffer import upload_scene
    from vkr.tools.render import load_preset

    cfg = RenderConfig(width=args.width, height=args.height)
    scene_cpu, preset = load_preset(args.scene, args.tex_size)
    scene = upload_scene(scene_cpu)
    res = build_ssr_resources(1024)
    view = look_at(preset["eye"], preset["center"], (0, -1, 0))
    cam = camera_frame(cfg, view, view, 1)
    state = FrameState.initial(args.height, args.width)
    interpret = pallas_interpret()
    if args.plain:
        use_plain_twins()

    def frame(s, st, c, r):
        return render_frame(s, st, c, r, cfg, interpret=interpret)

    frame_args = (scene, state, cam, res)
    names = pass_names(frame, *frame_args)
    result = device_times(jax.jit(frame), frame_args, steps=args.frames,
                          scopes=names,
                          absent=TWIN_KERNELS if args.plain else ())
    result["device"] = jax.devices()[0].device_kind
    result["route"] = "plain" if args.plain else "kernel"
    print(json.dumps(result, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
