#!/usr/bin/env python3
"""Smoke test of the renderer on one NVIDIA GPU: the quickest proof that
the full frame still compiles and runs on the card.

    python chip_smoke.py               # one card: phases a-d
    python chip_smoke.py --four-cards  # the four-card band/view path only

Phases (each prints its lines; any failure exits non-zero before the
result line):

  a. the card (nvidia-smi name and power limit), JAX's device kind and
     version;
  b. each hand-written kernel at bench widths, compiled for the card,
     against its plain-XLA reference, with compiled.memory_analysis():
       - the tile rasterizer (raster.kernel.raster_tiles) vs
         raster_tiles_xla over the same binned pairs of the bench frame;
       - the SSR march (passes.ssr_march.march_kernel) vs march_plain on
         the bench frame's reflection rays;
  c. the main path: the bench scene (>= 300k triangles, 69 textures at
     1024^2) at 1920x1080 through render_frame, jitted with state
     donation, for 16 orbit frames: coverage, overflow, finite colour,
     compile time, median frame time, peak device memory;
  d. per-pass parity at 256^2 of the kernel route against the oracle
     route (tools/parity.py).

The last line of standard output is one JSON object naming the device.
Exits non-zero, printing no result, when JAX finds no GPU or the package
is missing.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# Tolerances, each with its reason.
# Raster: the kernel and the XLA comparator evaluate the same plane
# equations, but Triton may contract a*x + b*y + c into FMAs where XLA
# does not: a pixel whose depth ties another triangle's within an ulp can
# pick the other winner.
RASTER_MIN_ID_AGREEMENT = 0.9999
# Attributes are the same plane replay of the same winner row: 1e-5
# relative (on |value| >= 1e-3) covers FMA-contraction rounding.
RASTER_ATTR_RTOL = 1e-5
# March: one transcription of the step runs in both; FMA contraction can
# flip a knife-edge DDA decision of a grazing ray.
MARCH_MIN_VALID_AGREEMENT = 0.999
MARCH_MIN_WITHIN_TEXEL = 0.999
# Whole frame: the BASELINE bar per pass.
PARITY_MIN_DB = 40.0
# Four cards vs one: every pixel of the band-parallel frame within 4e-3
# of the one-card frame (below the 1/255 display step).
BAND_MAX_DEVIATION = 4e-3
COVERAGE_MIN = 0.98


def say(*a):
    print(*a, flush=True)


def median_ms(fn, *args, reps=10):
    import jax
    import numpy as np

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def memory_line(name, jitted, *args):
    ma = jitted.lower(*args).compile().memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes")
    vals = {f: getattr(ma, f, None) for f in fields}
    say(f"  memory {name}: " + ", ".join(
        f"{k.replace('_in_bytes', '')}={v / 2**20:.1f} MiB"
        for k, v in vals.items() if v is not None))


def phase_a():
    import jax

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    for line in out.stdout.strip().splitlines():
        say(f"card: {line.strip()}")
    dev = jax.devices()[0]
    say(f"jax {jax.__version__}: {len(jax.devices())} x {dev.device_kind} "
        f"({dev.platform})")


def bench_scene(tex_size=1024):
    from vkr.passes.gbuffer import upload_scene
    from vkr.scene.procedural import sponza_colonnade_scene

    t0 = time.perf_counter()
    scene = upload_scene(sponza_colonnade_scene(
        columns=24, tessellation=80, tex_size=tex_size))
    n = int(scene.tri_opaque.shape[0] + scene.tri_masked.shape[0])
    say(f"bench scene: {n} triangles, built and uploaded in "
        f"{time.perf_counter() - t0:.1f} s")
    if n < 300_000:
        raise SystemExit(f"bench scene has only {n} triangles")
    return scene


def phase_b(scene, cfg):
    """Kernels vs their plain references at bench widths."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from bench import bench_orbit_view
    from vkr.core import registry
    from vkr.frame import _normal_mat4, build_ssr_resources, camera_frame
    from vkr.passes import ssr as S
    from vkr.passes.ssr_march import march_kernel, march_plain
    from vkr.raster import rasterize
    from vkr.raster.kernel import raster_tiles, raster_tiles_xla
    from vkr.raster.pair_rows import resolve_planes
    from vkr.raster.setup import corner_transform_t

    W, H = cfg.width, cfg.height
    cam = camera_frame(cfg, bench_orbit_view(1), bench_orbit_view(0), 1)

    # -- raster: the opaque subset's binned pairs of bench frame 1
    @jax.jit
    def front_end(s, c):
        attrs = jnp.concatenate(
            [s.corner_attr_o, corner_transform_t(s.corner_world_o,
                                                 c.prev_mvp)], 0)
        vis = rasterize(None, s.tri_opaque, width=W, height=H,
                        jitter=c.jitter, tri_mat=s.tri_opaque_mat,
                        corners_t=corner_transform_t(s.corner_world_o,
                                                     c.mvp),
                        corner_attrs_t=attrs, keep_prepared=True)
        return vis.prepared, vis.overflow

    prep, overflow = front_end(scene, cam)
    if int(overflow) != 0:
        raise SystemExit(f"raster overflow {int(overflow)} on frame 1")
    n_tri = int(scene.tri_opaque.shape[0])
    live = int(prep.seg_starts[-1] + prep.seg_counts[-1])
    say(f"raster pairs: {live} live of capacity {prep.pair_rows.shape[0]} "
        f"({live / n_tri:.3f} x T)")
    args = (prep.pair_rows, prep.seg_starts, prep.seg_counts)
    kern = jax.jit(lambda *a: raster_tiles(*a, width=W, height=H))
    plain = jax.jit(lambda *a: raster_tiles_xla(*a, width=W, height=H))
    zk, tk = kern(*args)
    zx, tx = plain(*args)
    tk, tx = np.asarray(tk)[:H, :W], np.asarray(tx)[:H, :W]
    id_agree = float((tk == tx).mean())
    z_agree = float((np.asarray(zk)[:H, :W] == np.asarray(zx)[:H, :W])
                    .mean())
    ak = np.asarray(resolve_planes(prep.tri_rows, jnp.asarray(tk), W, H))
    ax = np.asarray(resolve_planes(prep.tri_rows, jnp.asarray(tx), W, H))
    rel = np.abs(ak - ax) / np.maximum(np.abs(ax), 1e-3)
    attr_ok = float((rel.max(-1) <= RASTER_ATTR_RTOL).mean())
    t_k, t_x = median_ms(kern, *args), median_ms(plain, *args)
    say(f"raster_tiles vs raster_tiles_xla: id agreement {id_agree:.6f}, "
        f"depth agreement {z_agree:.6f}, attributes within "
        f"{RASTER_ATTR_RTOL:g} rel on {attr_ok:.6f} of pixels; "
        f"kernel {t_k:.3f} ms, plain {t_x:.3f} ms (wall, synced)")
    memory_line("raster_tiles", kern, *args)
    memory_line("raster_tiles_xla", plain, *args)
    if id_agree < RASTER_MIN_ID_AGREEMENT or z_agree < \
            RASTER_MIN_ID_AGREEMENT or attr_ok < RASTER_MIN_ID_AGREEMENT:
        raise SystemExit("raster kernel disagrees with its reference")

    # -- march: the bench frame's reflection rays
    gbuf = jax.jit(lambda s, c: registry.get("gbuf_opaque_taa")(
        s, c.mvp, c.prev_mvp, c.jitter, width=W, height=H,
        mask_peel_layers=cfg.raster.mask_peel_layers))(scene, cam)
    hiz = jax.jit(registry.get("downsample_hiz"))(
        gbuf.depth, gbuf.normal, gbuf.velocity)
    pyr = S.pack_pyramid(hiz.mips)
    res = build_ssr_resources(1024)
    sp = S.SSRParams(normal_mat=_normal_mat4(cam.view),
                     fovy=cfg.camera.fovy, aspect=cfg.aspect,
                     znear=cfg.camera.znear, zfar=cfg.camera.zfar)
    # the pyramid's level table is static: close over it, pass the data
    levels = pyr._replace(flat=None)
    rays = jax.jit(lambda f, n, m: S.trace_rays(
        levels._replace(flat=f), n, m, sp, jnp.int32(1), res.halton))(
        pyr.flat, hiz.normal_half, gbuf.material)
    margs = (pyr.flat, rays["ray_start"], rays["ray_dir"],
             rays["view_vec"], rays["w0"])
    it_max = cfg.ssr.max_iterations
    mk = jax.jit(lambda f, *a: march_kernel(levels._replace(flat=f), *a,
                                            sp, it_max))
    mp = jax.jit(lambda f, *a: march_plain(levels._replace(flat=f), *a,
                                           sp, it_max))
    pk, _, ik = mk(*margs)
    pp, _, ip = mp(*margs)
    vk, vp = np.asarray(ik) <= it_max, np.asarray(ip) <= it_max
    v_agree = float((vk == vp).mean())
    both = vk & vp
    texel = np.array([pyr.widths[0], pyr.heights[0]], np.float32)
    duv = np.abs(np.asarray(pk)[..., :2] - np.asarray(pp)[..., :2]) * texel
    within = float((duv[both].max(-1) <= 1.0).mean()) if both.any() else 0.0
    t_mk, t_mp = median_ms(mk, *margs), median_ms(mp, *margs)
    say(f"march_kernel vs march_plain ({rays['ray_start'].shape[0]}x"
        f"{rays['ray_start'].shape[1]} rays, {it_max} iterations): "
        f"validity agreement {v_agree:.6f} ({int(vp.sum())} valid), hit "
        f"uv within 1 texel on {within:.6f} of both-valid rays; kernel "
        f"{t_mk:.3f} ms, plain {t_mp:.3f} ms (wall, synced)")
    memory_line("march_kernel", mk, *margs)
    memory_line("march_plain", mp, *margs)
    if v_agree < MARCH_MIN_VALID_AGREEMENT or \
            within < MARCH_MIN_WITHIN_TEXEL:
        raise SystemExit("march kernel disagrees with its reference")


def phase_c(scene, cfg, frames=16):
    """The main path at 1080p with frames in flight over the bench orbit."""
    import jax
    import numpy as np

    from bench import bench_orbit_view
    from vkr.core.framestate import FrameState
    from vkr.frame import build_ssr_resources, camera_frame, render_frame

    res = build_ssr_resources(1024)
    step = jax.jit(lambda s, st, c, r: render_frame(s, st, c, r, cfg),
                   donate_argnums=(1,))
    state = FrameState.initial(cfg.height, cfg.width)
    views = [bench_orbit_view(i) for i in range(frames)]
    t0 = time.perf_counter()
    color, state, aux = step(scene, state,
                             camera_frame(cfg, views[0], views[0], 0), res)
    jax.block_until_ready(color)
    compile_s = time.perf_counter() - t0
    times, overflow = [], int(aux["overflow"])
    for i in range(1, frames):
        cam = camera_frame(cfg, views[i], views[i - 1], i)
        t0 = time.perf_counter()
        color, state, aux = step(scene, state, cam, res)
        jax.block_until_ready(color)
        times.append(time.perf_counter() - t0)
        overflow = max(overflow, int(aux["overflow"]))
    cov = float(np.mean(np.asarray(state.prev_depth) < 1.0))
    finite = bool(np.isfinite(np.asarray(color)).all())
    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use", 0)
    ms = np.asarray(times) * 1e3
    say(f"frame {cfg.width}x{cfg.height}: compile+first {compile_s:.1f} s, "
        f"median {np.median(ms):.2f} ms (p10 {np.percentile(ms, 10):.2f}, "
        f"p90 {np.percentile(ms, 90):.2f}) over {len(ms)} frames, "
        f"coverage {cov:.4f}, overflow {overflow}, finite {finite}, "
        f"peak {peak / 2**30:.2f} GiB")
    if cov < COVERAGE_MIN or overflow != 0 or not finite:
        raise SystemExit("main path failed its checks")


def phase_d():
    from vkr.tools.parity import measure

    psnr = measure(size=256, interpret=False)
    say("parity 256^2 (kernel route vs oracle route, dB): "
        + ", ".join(f"{k} {v}" for k, v in psnr.items()))
    low = {k: v for k, v in psnr.items() if v < PARITY_MIN_DB}
    if low:
        raise SystemExit(f"passes below {PARITY_MIN_DB} dB: {low}")


def phase_e(width=2560, height=1440, tex_size=1024, view_size=(640, 360)):
    """Four cards: the band-parallel frame against the same frame on one
    card, then one view-parallel step. The three programs compile
    concurrently (compilation runs on the host)."""
    import dataclasses
    from concurrent.futures import ThreadPoolExecutor

    import jax
    import numpy as np

    from bench import bench_orbit_view
    from vkr.config import RenderConfig
    from vkr.core.framestate import FrameState
    from vkr.core.platform import pallas_interpret
    from vkr.frame import build_ssr_resources, camera_frame, render_frame
    from vkr.parallel import make_render_mesh, render_frame_banded
    from vkr.parallel import render_views_sharded
    from vkr.parallel.sharding import batch_cams, batch_states

    n = len(jax.devices())
    if n != 4:
        raise SystemExit(f"--four-cards needs 4 devices, found {n}")
    scene = bench_scene(tex_size)
    res = build_ssr_resources(1024)
    cfg = RenderConfig(width=width, height=height)
    mesh = make_render_mesh(4)
    cam = camera_frame(cfg, bench_orbit_view(1), bench_orbit_view(0), 1)
    state = FrameState.initial(cfg.height, cfg.width)
    vw, vh = view_size
    small = dataclasses.replace(cfg, width=vw, height=vh)
    cams = batch_cams([camera_frame(small, bench_orbit_view(i),
                                    bench_orbit_view(i), i)
                       for i in range(4)])
    states = batch_states(lambda: FrameState.initial(vh, vw), 4)

    interp = pallas_interpret()  # False on the GPU
    band = jax.jit(lambda s, st, c: render_frame_banded(
        s, st, c, res, cfg, mesh, interpret=interp))
    one = jax.jit(lambda s, st, c: render_frame(
        s, st, c, res, cfg, interpret=interp))
    views = jax.jit(lambda s, st, c: render_views_sharded(
        s, st, c, res, small, mesh, interpret=interp))
    t0 = time.perf_counter()
    lowered = [band.lower(scene, state, cam), one.lower(scene, state, cam),
               views.lower(scene, states, cams)]
    with ThreadPoolExecutor(len(lowered)) as pool:
        list(pool.map(lambda low: low.compile(), lowered))
    t_compile = time.perf_counter() - t0

    t0 = time.perf_counter()
    color_b, state_b, aux_b = band(scene, state, cam)
    color_b = np.asarray(color_b)
    t_b = time.perf_counter() - t0
    t0 = time.perf_counter()
    color_1, state_1, aux_1 = one(scene, state, cam)
    color_1 = np.asarray(color_1)
    t_1 = time.perf_counter() - t0
    dev = np.abs(color_b - color_1).max(-1)
    over = float((dev > BAND_MAX_DEVIATION).mean())
    say(f"band-parallel {width}x{height} on 4 cards vs 1 card: max "
        f"deviation {dev.max():.3e} (limit {BAND_MAX_DEVIATION:g}), "
        f"{over:.6f} of pixels above it, overflow "
        f"{int(aux_b['overflow'])}; compile {t_compile:.1f} s (three "
        f"programs at once), first run {t_b:.1f} s (4 cards), {t_1:.1f} s "
        f"(1 card)")
    band_ok = dev.max() <= BAND_MAX_DEVIATION and \
        int(aux_b["overflow"]) == 0
    # where the two frames part: every product both programs return
    for name, a, b in _frame_products(aux_b, state_b, aux_1, state_1):
        d = np.abs(np.asarray(a, np.float64) - np.asarray(b))
        say(f"  {name}: max deviation {d.max():.3e}, "
            f"{float((d > 1e-6).mean()):.6f} of values above 1e-6")

    colors = np.asarray(views(scene, states, cams)[0])
    ok = colors.shape == (4, vh, vw, 3) and np.isfinite(colors).all()
    say(f"view-parallel step: 4 views of {vw}x{vh}, shape {colors.shape}, "
        f"finite {bool(np.isfinite(colors).all())}")
    if not band_ok:
        raise SystemExit("band-parallel frame deviates")
    if not ok:
        raise SystemExit("view-parallel step failed")


def _frame_products(aux_a, state_a, aux_b, state_b):
    """(name, a, b) for the G-buffer planes, the image-space products and
    the history buffers of two frames, in pass order."""
    out = [(f"gbuffer.{f}", getattr(aux_a["gbuffer"], f),
            getattr(aux_b["gbuffer"], f))
           for f in ("depth", "normal", "velocity", "albedo", "material")]
    out += [(k, aux_a[k], aux_b[k]) for k in ("hiz_depth", "ssr", "ao")]
    out += [(f"state.{f}", getattr(state_a, f), getattr(state_b, f))
            for f in ("gtao_accum", "ssr_history", "taa_history")]
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the four-card band/view path")
    args = parser.parse_args()

    if not os.path.isdir(os.path.join(REPO, "vkr")):
        print("error: chip_smoke.py must run from a checkout of the "
              "repository (vkr/ not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from vkr.core.platform import ensure_platform, require_gpu

    ensure_platform()
    require_gpu()
    import jax

    from vkr.config import RenderConfig

    phase_a()
    if args.four_cards:
        phase_e()
    else:
        cfg = RenderConfig(width=1920, height=1080)
        scene = bench_scene()
        phase_b(scene, cfg)
        phase_c(scene, cfg)
        phase_d()
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
