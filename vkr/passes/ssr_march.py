"""The SSR hi-Z ray march (trace.comp:171-236 over screen_trace.glsl).

One ray per half-res pixel walks the depth pyramid for up to
`max_iterations` steps: a data-dependent loop with one pyramid fetch per
step. The step is written once, component-wise (`_step`), and run two
ways:

  * `march_plain` — plain XLA: a `while_loop` over the whole ray grid
    (the reference's own shape: every ray, no compaction, no drop).
  * `march_kernel` — the GPU kernel (Pallas through Triton): one program
    per block of RAY_BLOCK rays runs the whole loop with the ray state in
    registers and fetches the flat pyramid (L2-resident at bench size) by
    computed index. A block stops when all its rays are done.

Both return (position (..., 3), horizon (...,), iterations (...,)); an
iteration count above `max_iterations` marks an invalid ray.

`hiz` is a FlatPyramid (passes/ssr.py): the pyramid levels packed into
one flat array with static per-level offsets, heights and widths.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

MAX_T = 3.402823466e38
RAY_BLOCK = 128
NUM_WARPS = 4
NUM_STAGES = 1
_N_IN = 13   # origin(3) direction(3) camera_start(3) w0(3) pad flag
_N_OUT = 5   # position(3) horizon iterations


def _consts(o, d, screen, most_detailed_mip):
    """Per-ray constants of the march (screen_trace.glsl:8-45)."""
    inv_d = [jnp.where(dk != 0.0, 1.0 / jnp.where(dk == 0, 1.0, dk), MAX_T)
             for dk in d]
    # 0.005 * exp2(most_detailed_mip) / screen (screen_trace.glsl:71)
    mag = [0.005 * (2.0 ** most_detailed_mip) / s for s in screen]
    uv_off = [jnp.where(d[k] < 0, -mag[k], mag[k]) for k in range(2)]
    floor_off = [jnp.where(d[k] < 0, 0.0, 1.0) for k in range(2)]
    return dict(o=o, d=d, inv_d=inv_d, uv_off=uv_off, floor_off=floor_off)


def _start(c, screen, most_detailed_mip):
    """initial_advance_ray (screen_trace.glsl:8-15): (position, t)."""
    res = [s * (2.0 ** -most_detailed_mip) for s in screen]
    t0 = [((jnp.floor(res[k] * c["o"][k]) + c["floor_off"][k]) / res[k]
           + c["uv_off"][k] - c["o"][k]) * c["inv_d"][k] for k in range(2)]
    t = jnp.minimum(t0[0], t0[1])
    return [c["o"][k] + t * c["d"][k] for k in range(3)], t


def _step(i, st, c, cam, w0, fetch, *, screen, n_mips, view, find_hor,
          most_detailed_mip):
    """One march iteration for every ray (trace.comp:191-236). st holds
    pos [3], t, mip, hor, iters, done, oob; fetch(mip, x, y) is the
    pyramid texelFetch."""
    pos, mip = st["pos"], st["mip"]
    scale = jnp.exp2(-mip.astype(jnp.float32))
    mip_res = [screen[0] * scale, screen[1] * scale]
    mip_pos = [mip_res[k] * pos[k] for k in range(2)]
    surface_z = fetch(jnp.clip(mip, 0, n_mips - 1),
                      mip_pos[0].astype(jnp.int32),
                      mip_pos[1].astype(jnp.int32))

    # advance_ray (screen_trace.glsl:17-45)
    t_xy = [((jnp.floor(mip_pos[k]) + c["floor_off"][k]) / mip_res[k]
             + c["uv_off"][k] - c["o"][k]) * c["inv_d"][k]
            for k in range(2)]
    t_z = jnp.where(c["d"][2] > 0,
                    (surface_z - c["o"][2]) * c["inv_d"][2], MAX_T)
    t_min = jnp.minimum(jnp.minimum(t_xy[0], t_xy[1]), t_z)
    above = surface_z > pos[2]
    skipped = (t_min != t_z) & above
    # Keep t finite: a zero direction component otherwise gives inf * 0.
    new_t = jnp.clip(jnp.where(above, t_min, st["t"]), -1e20, 1e20)

    if find_hor:  # the fixed fine-mip prefix (trace.comp:191 `i < 15`)
        dmip = jnp.where(i < 15, 0, jnp.where(skipped, 1, -1))
    else:
        dmip = jnp.where(skipped, 1, -1)

    act = ~st["done"]
    pos = [jnp.where(act, c["o"][k] + new_t * c["d"][k], pos[k])
           for k in range(3)]
    t = jnp.where(act, new_t, st["t"])
    mip_out = jnp.where(act, mip + dmip, mip)

    # horizon estimate on fine mips (trace.comp:214-223)
    tg, aspect, znear, zfar = view
    vz = znear * zfar / (surface_z * (zfar - znear) - zfar)
    v = [-(2.0 * pos[0] - 1.0) * (vz * aspect * tg) - cam[0],
         -(2.0 * pos[1] - 1.0) * (vz * tg) - cam[1],
         vz - cam[2]]
    v_len = jnp.maximum(jnp.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]),
                        1e-20)
    h2 = (w0[0] * (v[0] / v_len) + w0[1] * (v[1] / v_len)
          + w0[2] * (v[2] / v_len))
    hor_upd = act & (mip_out <= 1) & (v_len < 0.3)
    hor = jnp.where(hor_upd, jnp.maximum(st["hor"], h2), st["hor"])

    iters = jnp.where(act, i + 1, st["iters"])
    done = st["done"] | (mip_out < most_detailed_mip)
    # A ray outside the screen moving further out can never intersect
    # again: retire it invalid (the reference burns its remaining
    # iterations and ends invalid).
    d = c["d"]
    oob = (((pos[0] < 0.0) & (d[0] <= 0.0)) | ((pos[0] > 1.0) & (d[0] >= 0.0))
           | ((pos[1] < 0.0) & (d[1] <= 0.0))
           | ((pos[1] > 1.0) & (d[1] >= 0.0)))
    newly_oob = act & oob & (mip_out >= 0)
    return dict(pos=pos, t=t, mip=mip_out, hor=hor, iters=iters,
                done=done | newly_oob, oob=st["oob"] | newly_oob)


def _init_state(c, screen, most_detailed_mip, done):
    pos, t = _start(c, screen, most_detailed_mip)
    zi = jnp.zeros_like(t, jnp.int32)
    return dict(pos=pos, t=t, mip=zi + most_detailed_mip,
                hor=jnp.zeros_like(t), iters=zi, done=done,
                oob=jnp.zeros_like(done))


def _finish(st, max_iterations):
    """valid iff the ray stopped (not out of bounds) within the cap."""
    iters = jnp.where(st["done"] & ~st["oob"], st["iters"],
                      max_iterations + 1)
    pos = [jnp.clip(jnp.where(jnp.isfinite(p), p, 0.0), -1e6, 1e6)
           for p in st["pos"]]
    return pos, st["hor"], iters


def _view(params):
    return (math.tan(params.fovy / 2.0), params.aspect, params.znear,
            params.zfar)


def _split(a):
    return [a[..., k] for k in range(a.shape[-1])]


def march_plain(hiz, origin, direction, camera_start, w0, params,
                max_iterations: int, find_hor: bool = True,
                most_detailed_mip: int = 0):
    """The march as plain XLA over the whole ray grid (any leading
    shape). find_hor=False is the plain hierarchical_raymarch of
    screen_trace.glsl:51-101 (no fine-mip prefix); most_detailed_mip is
    the march's finest mip (trace_indirect.comp:101 starts glossy rays
    at mip 1)."""
    screen = (float(hiz.widths[0]), float(hiz.heights[0]))
    offs = jnp.asarray(hiz.offsets, jnp.int32)
    hs = jnp.asarray(hiz.heights, jnp.int32)
    ws = jnp.asarray(hiz.widths, jnp.int32)

    def fetch(mip, x, y):
        w = ws[mip]
        return hiz.flat[offs[mip] + jnp.clip(y, 0, hs[mip] - 1) * w
                        + jnp.clip(x, 0, w - 1)]

    c = _consts(_split(origin), _split(direction), screen,
                most_detailed_mip)
    cam, w0s = _split(camera_start), _split(w0)
    st = _init_state(c, screen, most_detailed_mip,
                     jnp.zeros(origin.shape[:-1], bool))
    step = functools.partial(
        _step, c=c, cam=cam, w0=w0s, fetch=fetch, screen=screen,
        n_mips=len(hiz.offsets), view=_view(params), find_hor=find_hor,
        most_detailed_mip=most_detailed_mip)
    _, st = jax.lax.while_loop(
        lambda s: (s[0] < max_iterations) & jnp.any(~s[1]["done"]),
        lambda s: (s[0] + 1, step(s[0], s[1])),
        (jnp.asarray(0, jnp.int32), st))
    pos, hor, iters = _finish(st, max_iterations)
    return jnp.stack(pos, -1), hor, iters


def _march_block(rays_ref, pyr_ref, out_ref, *, screen, levels, view,
                 max_iterations, find_hor, most_detailed_mip):
    f = [rays_ref[k, :] for k in range(_N_IN)]
    n_mips = len(levels)

    def fetch(mip, x, y):
        off, hh, ww = levels[0]
        for lvl in range(1, n_mips):
            o_l, h_l, w_l = levels[lvl]
            sel = mip == lvl
            off = jnp.where(sel, o_l, off)
            hh = jnp.where(sel, h_l, hh)
            ww = jnp.where(sel, w_l, ww)
        idx = off + jnp.clip(y, 0, hh - 1) * ww + jnp.clip(x, 0, ww - 1)
        return pyr_ref[idx]

    c = _consts(f[0:3], f[3:6], screen, most_detailed_mip)
    st = _init_state(c, screen, most_detailed_mip, f[12] > 0.0)
    step = functools.partial(
        _step, c=c, cam=f[6:9], w0=f[9:12], fetch=fetch, screen=screen,
        n_mips=n_mips, view=view, find_hor=find_hor,
        most_detailed_mip=most_detailed_mip)

    def cond(s):
        live = jnp.max(jnp.where(s[1]["done"], 0, 1))
        return (s[0] < max_iterations) & (live > 0)

    _, st = jax.lax.while_loop(
        cond, lambda s: (s[0] + 1, step(s[0], s[1])),
        (jnp.asarray(0, jnp.int32), st))
    pos, hor, iters = _finish(st, max_iterations)
    for k in range(3):
        out_ref[k, :] = pos[k]
    out_ref[3, :] = hor
    out_ref[4, :] = iters.astype(jnp.float32)


def march_kernel(hiz, origin, direction, camera_start, w0, params,
                 max_iterations: int, find_hor: bool = True,
                 most_detailed_mip: int = 0, interpret: bool = False):
    """march_plain as the GPU kernel: same arguments and results."""
    lead = origin.shape[:-1]
    n = math.prod(lead)
    n_pad = -(-n // RAY_BLOCK) * RAY_BLOCK
    pad_flag = (jnp.arange(n_pad) >= n).astype(jnp.float32)[None]
    rays = jnp.concatenate(
        [a.reshape(n, 3).T for a in (origin, direction, camera_start, w0)],
        axis=0)
    rays = jnp.concatenate(
        [jnp.pad(rays, ((0, 0), (0, n_pad - n))), pad_flag], axis=0)
    kernel = functools.partial(
        _march_block,
        screen=(float(hiz.widths[0]), float(hiz.heights[0])),
        levels=tuple(zip(hiz.offsets, hiz.heights, hiz.widths)),
        view=_view(params), max_iterations=max_iterations,
        find_hor=find_hor, most_detailed_mip=most_detailed_mip)
    out = pl.pallas_call(
        kernel,
        grid=(n_pad // RAY_BLOCK,),
        in_specs=[pl.BlockSpec((_N_IN, RAY_BLOCK), lambda i: (0, i)),
                  pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec((_N_OUT, RAY_BLOCK), lambda i: (0, i)),
        out_shape=jax.ShapeDtypeStruct((_N_OUT, n_pad), jnp.float32),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=NUM_STAGES),
        interpret=interpret,
        name="ssr_march",
    )(rays, hiz.flat)[:, :n]
    pos = out[:3].T.reshape(lead + (3,))
    return (pos, out[3].reshape(lead),
            out[4].astype(jnp.int32).reshape(lead))
