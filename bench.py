"""Benchmark: full-pipeline frame time at 1920x1080 on one GPU.

Prints ONE JSON line on stdout: {"metric", "value", "unit", "device"}
with the median frame interval (ms) of the frames-in-flight loop over the
bench orbit. The device (platform, kind, count) and the card's power
limit go to stderr beside every number. Needs a GPU: on any other
backend it exits without a result.

Scene: the procedural colonnade at Sponza scale (>= 300k triangles, a
Sponza-shaped 69-texture set at 1024^2; vkr/scene/procedural.py).

Per-pass-group timing breakdown goes to stderr (BENCH_BREAKDOWN=0 to
skip): the frame's three segments (G-buffer raster | hi-Z+SSR+GTAO |
shading+TAA) are jitted separately (frame.frame_mid / frame_tail) and
each is timed with block_until_ready. The per-pass device split comes
from `python -m vkr.tools.profile` (a profiler trace).
"""

import functools
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from vkr.core.platform import ensure_platform, require_gpu


def _breakdown(scene, state, cam, ssr_res, cfg, reps=4):
    """Per-pass-group ms to stderr (BASELINE.json asks for raster / GTAO /
    SSR / TAA attribution): segment-jit the frame (G-buffer | frame_mid =
    hi-Z+SSR+GTAO | frame_tail = shading+TAA) and time R synced calls per
    segment."""
    import time as _time

    import jax

    from vkr.core import registry
    from vkr.frame import frame_mid, frame_tail

    jit_gbuf = jax.jit(lambda s, c: registry.get("gbuf_opaque_taa")(
        s, c.mvp, c.prev_mvp, c.jitter, width=cfg.width,
        height=cfg.height, quantize=cfg.quantize_formats,
        mask_peel_layers=cfg.raster.mask_peel_layers,
        trilinear=cfg.trilinear_textures,
    ))
    jit_mid = jax.jit(lambda gb, st, c: frame_mid(gb, st, c, ssr_res, cfg))
    jit_tail = jax.jit(lambda gb, m, st, c: frame_tail(
        gb, m, st, c, ssr_res, cfg))

    gbuf = jit_gbuf(scene, cam)
    mid = jit_mid(gbuf, state, cam)
    jax.block_until_ready(jit_tail(gbuf, mid, state, cam))  # compiles

    def timed(name, fn):
        jax.block_until_ready(fn())  # warm
        t0 = _time.perf_counter()
        for _i in range(reps):
            jax.block_until_ready(fn())
        ms = (_time.perf_counter() - t0) / reps * 1e3
        print(f"breakdown {name}: {ms:.2f} ms", file=sys.stderr)
        return ms

    total = timed("gbuffer(raster+tex)", lambda: jit_gbuf(scene, cam))
    total += timed("mid(hiz+ssr+gtao)", lambda: jit_mid(gbuf, state, cam))
    total += timed("tail(shading+taa)",
                   lambda: jit_tail(gbuf, mid, state, cam))
    print(f"breakdown sum: {total:.2f} ms (three synced segments; the "
          f"fused frame is the headline)", file=sys.stderr)


BENCH_EYE = (-18.0, 2.2, -2.0)
BENCH_CENTER = (4.0, 1.8, 0.5)


def bench_orbit_view(i: int):
    """Frame i's view matrix: a slow orbit of BENCH_EYE around
    BENCH_CENTER. The orbit rate must keep the eye INSIDE the hall: the
    walls sit at z = +-6 and the orbit radius is ~22.1, so eye z =
    0.5 - 22*sin(ang) - 2.5*cos(ang) crosses the z=-6 wall plane at
    ang ~= 0.185. The old 0.02*i rate pushed frames >= 10 OUTSIDE the
    enclosure (the view became the wall's exterior + background; coverage
    collapsed to 0.579 and under-stated the workload — round-2/3 medians
    carried ~6 such cheap frames). 0.01*i keeps all 16 frames inside
    (max ang 0.15 -> eye z -5.25). tests/test_raster.py guards this.
    """
    import numpy as np

    from vkr.mathlib import look_at

    eye = np.array(BENCH_EYE, np.float32)
    center = np.array(BENCH_CENTER, np.float32)
    ang = 0.01 * i
    rot = np.array(
        [[np.cos(ang), 0, -np.sin(ang)], [0, 1, 0],
         [np.sin(ang), 0, np.cos(ang)]], np.float32)
    return look_at(center + rot @ (eye - center), center, (0, -1, 0))


def card_line() -> str:
    """nvidia-smi's name and power limit of the cards ("" without it)."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return ""
    return "; ".join(out.stdout.strip().splitlines())


def main():
    ensure_platform()
    require_gpu()
    import dataclasses

    import jax
    import numpy as np

    from vkr.config import RenderConfig
    from vkr.core.framestate import FrameState
    from vkr.frame import (
        build_ssr_resources,
        camera_frame,
        render_frame,
    )
    from vkr.mathlib import look_at
    from vkr.passes.gbuffer import upload_scene
    from vkr.scene import colonnade_scene

    res = os.environ.get("BENCH_RES", "1920x1080")
    width, height = (int(v) for v in res.split("x"))
    frames = int(os.environ.get("BENCH_FRAMES", "16"))
    # Fail BEFORE the (possibly ~20-min cold) compile: the pipelined loop
    # needs >= 2 frames, and the orbit leaves the hall enclosure past
    # frame 18 (bench_orbit_view docstring) which would only surface as a
    # coverage failure after the full run.
    if not 2 <= frames <= 18:
        print(f"ERROR: BENCH_FRAMES={frames} out of range [2, 18] "
              f"(>18 exits the hall enclosure; <2 has no timed frame)",
              file=sys.stderr)
        sys.exit(1)
    ssr_iters = int(os.environ.get("BENCH_SSR_ITERS", "80"))
    scene_kind = os.environ.get("BENCH_SCENE", "sponza_tex")
    tex_size = int(os.environ.get("BENCH_TEX", "1024"))

    cfg = RenderConfig(width=width, height=height)
    cfg = dataclasses.replace(
        cfg, ssr=dataclasses.replace(cfg.ssr, max_iterations=ssr_iters)
    )

    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    print(f"device: {device}; card: {card_line()}", file=sys.stderr)
    t0 = time.time()
    if scene_kind == "sponza_tex":
        # Reference-scale workload: >=300k tris (vs Sponza's ~260k,
        # main.cpp:217-218) with a Sponza-shaped 25-material /
        # 69-texture set at 1024^2 (procedural.py).
        from vkr.scene.procedural import sponza_colonnade_scene

        scene_cpu = sponza_colonnade_scene(
            columns=24, tessellation=80, tex_size=tex_size
        )
    else:
        scene_cpu = colonnade_scene(columns=16, tessellation=64,
                                    tex_size=512)
    scene = upload_scene(scene_cpu)
    ssr_res = build_ssr_resources(1024)
    print(f"scene+LUTs: {time.time()-t0:.1f}s "
          f"({scene.tri_opaque.shape[0] + scene.tri_masked.shape[0]} tris)",
          file=sys.stderr)

    view_at = bench_orbit_view

    state = FrameState.initial(height, width)
    view = prev = view_at(0)
    t0 = time.time()
    cam = camera_frame(cfg, view, prev, 0)
    jitted = functools.partial(jax.jit(
        lambda s, st, c, r: render_frame(s, st, c, r, cfg),
        donate_argnums=(1,)), r=ssr_res)
    color, state, aux = jitted(scene, state, cam)
    jax.block_until_ready(color)
    compile_s = time.time() - t0
    print(f"compile+first: {compile_s:.1f}s", file=sys.stderr)

    # Frames-in-flight pipelining (the reference keeps 2-3 frames in
    # flight through its swapchain/fences; PARITY.md §2.5 row): dispatch
    # frame i+1 BEFORE syncing frame i so host work overlaps device
    # execution. Per-frame time = interval between successive frame
    # COMPLETIONS — the sustained rate a swapchain would present at.
    # BENCH_PIPELINE=0 measures the serial dispatch->sync latency.
    pipelined = os.environ.get("BENCH_PIPELINE", "1") == "1"
    times = []
    if pipelined:
        prev_color = t_mark = None
        for i in range(1, frames):
            prev, view = view, view_at(i)
            cam = camera_frame(cfg, view, prev, i)
            color, state, aux = jitted(scene, state, cam)
            if prev_color is None:
                t_mark = time.time()
            else:
                jax.block_until_ready(prev_color)  # frame i-1 completed
                t = time.time()
                times.append(t - t_mark)
                t_mark = t
            prev_color = color
        jax.block_until_ready(prev_color)
        times.append(time.time() - t_mark)
    else:
        for i in range(1, frames):
            prev, view = view, view_at(i)
            cam = camera_frame(cfg, view, prev, i)
            t0 = time.time()
            color, state, aux = jitted(scene, state, cam)
            jax.block_until_ready(color)
            times.append(time.time() - t0)

    ms = float(np.median(times)) * 1e3
    cov = float(np.mean(np.asarray(state.prev_depth) < 1.0))
    dropped = int(np.asarray(aux["overflow"]))
    if dropped != 0:
        print(f"ERROR: raster bin overflow — {dropped} pairs dropped "
              f"(geometry lost; raise pair_factor)", file=sys.stderr)
        sys.exit(1)
    ts = np.sort(np.asarray(times)) * 1e3
    peak = (dev.memory_stats() or {}).get("peak_bytes_in_use", 0)
    k = max(1, len(ts) // 4)
    trimmed = float(ts[k:-k].mean()) if len(ts) > 2 * k else float(ts.mean())
    print(f"coverage: {cov:.3f}  frames: {len(times)}  "
          f"min/median/max ms: {ts[0]:.1f}/{ms:.1f}/{ts[-1]:.1f}  "
          f"p10/p90: {np.percentile(ts, 10):.1f}/"
          f"{np.percentile(ts, 90):.1f}  trimmed25: {trimmed:.1f}  "
          f"peak: {peak / 2**30:.2f} GiB", file=sys.stderr)
    if cov < 0.98:
        # The enclosed hall must fill the frame; a coverage drop means the
        # camera path or scene regressed and the timing under-states the
        # real workload (this caught the orbit exiting the hall wall).
        print(f"ERROR: coverage {cov:.3f} < 0.98 — bench workload "
              f"regressed (camera left the enclosure?)", file=sys.stderr)
        sys.exit(1)

    # The breakdown jits 3 MORE segments; auto-skip it when the fused
    # compile was very slow (BENCH_BREAKDOWN=1 forces it regardless).
    want_bd = os.environ.get("BENCH_BREAKDOWN", "auto")
    if want_bd not in ("0", "1", "auto"):
        print(f"warning: BENCH_BREAKDOWN={want_bd!r} not one of 0/1/auto; "
              f"treating as 1", file=sys.stderr)
        want_bd = "1"
    if want_bd == "1" or (want_bd == "auto" and compile_s < 900):
        try:
            _breakdown(scene, state, cam, ssr_res, cfg)
        except Exception as e:  # never lose the headline JSON line
            print(f"breakdown failed: {e!r}", file=sys.stderr)

    print(json.dumps({
        "metric": "1080p_full_pipeline_frame_time",
        "value": ms,
        "unit": "ms",
        "device": device,
    }))


if __name__ == "__main__":
    main()
