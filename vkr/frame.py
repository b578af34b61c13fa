"""The full frame function — the reference's main loop as one pure pass DAG.

Mirrors main.cpp:338-402 frame order: G-buffer raster -> hi-Z downsample ->
SSR (trace/filter/blur) -> GTAO (main/filter/accumulate) -> deferred
shading -> TAA resolve. The reference's end-of-frame image remaps
(main.cpp:416-420) become the returned FrameState; jit with
donate_argnums on the state reproduces the zero-copy swap.
"""

from __future__ import annotations

import functools

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from vkr.config import RenderConfig
from vkr.core import registry
from vkr.core.framestate import FrameState
from vkr.core.graph import add_task
from vkr.mathlib.brdf import halton23_table
from vkr.mathlib.transforms import apply_linear
from vkr.mathlib.transforms import perspective, taa_jitter_sequence
from vkr.passes import downsample as _down
from vkr.passes import gtao as _gtao
from vkr.passes import ssr as _ssr
from vkr.passes import taa as _taa
from vkr.passes.gbuffer import SceneDevice
from vkr.passes.shading import ShadingParams


class SSRResources(NamedTuple):
    """Startup-preintegrated LUTs (advanced_ssr.cpp:95-136) + halton table."""

    pdf_lut: jnp.ndarray    # (S, S)
    brdf_lut: jnp.ndarray   # (S, S, 2)
    halton: jnp.ndarray     # (128, 2)


def build_ssr_resources(lut_size: int = 1024) -> SSRResources:
    """Preintegrated LUTs, disk-cached (each is a pure function of its
    size, so a process recomputes them only once per checkout)."""
    from vkr.core.diskcache import cached_npz

    luts = cached_npz(
        f"ssr-luts-{lut_size}",
        lambda: {
            "pdf": np.asarray(jax.jit(
                registry.get("pdf_preintegrate"), static_argnums=0
            )(lut_size)),
            "brdf": np.asarray(jax.jit(
                registry.get("brdf_preintegrate"), static_argnums=0
            )(lut_size)),
        },
    )
    return SSRResources(
        pdf_lut=jnp.asarray(luts["pdf"]),
        brdf_lut=jnp.asarray(luts["brdf"]),
        halton=jnp.asarray(halton23_table(_ssr.HALTON_SEQ_SIZE)),
    )


class Tuning(NamedTuple):
    """Per-frame tuning scalars — the reference's ImGui-slider push
    constants (GTAO weight_ratio gtao.cpp:533, SSSR max-roughness
    advanced_ssr.cpp:558, shading roughness remap
    defered_shading.cpp:122-123). Unlike RenderConfig these are TRACED:
    a slider move re-dispatches the same executable, exactly as a push-
    constant update re-records a command buffer without a pipeline
    rebuild. `Tuning.of(cfg)` takes the static config values, which is
    what the frame uses when no override is passed."""

    weight_ratio: jnp.ndarray        # GTAO MIS strategy weight (1..5)
    ssr_max_roughness: jnp.ndarray   # SSSR roughness cutoff/bias (0..1)
    shade_min_roughness: jnp.ndarray  # shading roughness remap lo (0..1)
    shade_max_roughness: jnp.ndarray  # shading roughness remap hi (0..1)
    ssr_temporal_rays: jnp.ndarray   # halton counter period, int (1..128)

    @staticmethod
    def of(cfg: RenderConfig) -> "Tuning":
        return Tuning(
            weight_ratio=cfg.gtao.weight_ratio,
            ssr_max_roughness=cfg.ssr.max_roughness,
            shade_min_roughness=cfg.shading.min_roughness,
            shade_max_roughness=cfg.shading.max_roughness,
            ssr_temporal_rays=cfg.ssr.max_accumulated_rays,
        )


class CameraFrame(NamedTuple):
    """Per-frame camera matrices, host-computed (DrawTAAParams analog,
    scene_renderer.hpp:26-33)."""

    view: jnp.ndarray        # (4,4)
    prev_view: jnp.ndarray
    mvp: jnp.ndarray         # proj @ view, unjittered
    prev_mvp: jnp.ndarray
    jitter: jnp.ndarray      # (2,) NDC offset


def camera_frame(cfg: RenderConfig, view, prev_view, frame_index: int,
                 use_jitter: bool = True) -> CameraFrame:
    proj = perspective(cfg.camera.fovy, cfg.aspect, cfg.camera.znear,
                       cfg.camera.zfar)
    seq = taa_jitter_sequence(cfg.width, cfg.height)
    jitter = seq[frame_index % 4] if (use_jitter and cfg.taa.jitter) else (
        np.zeros(2, np.float32)
    )
    return CameraFrame(
        view=jnp.asarray(view),
        prev_view=jnp.asarray(prev_view),
        mvp=jnp.asarray(proj @ view),
        prev_mvp=jnp.asarray(proj @ prev_view),
        jitter=jnp.asarray(jitter),
    )


def build_probe_grid(scene_cpu, cfg: RenderConfig, margin: float = 0.5,
                     probe_y: float = 1.5, use_pallas: bool = True,
                     interpret: bool = False):
    """Render the octahedral probe grid over the scene's xz bounds
    (startup task, like the reference's render_probe_grid call site,
    probe_renderer.cpp:290-384). scene_cpu: CompiledScene (host arrays
    for the bounds) — the device scene is uploaded internally."""
    import numpy as _np

    from vkr.passes.gbuffer import upload_scene
    from vkr.passes.probes import render_probe_grid

    pos = _np.asarray(scene_cpu.positions)
    lo = pos.min(axis=0) if len(pos) else _np.zeros(3)
    hi = pos.max(axis=0) if len(pos) else _np.zeros(3)
    pmin = _np.array([lo[0] + margin, probe_y, lo[2] + margin], _np.float32)
    pmax = _np.array([hi[0] - margin, probe_y, hi[2] - margin], _np.float32)
    return render_probe_grid(
        upload_scene(scene_cpu), pmin, pmax, cfg.probes.grid,
        cube_size=cfg.probes.cube_size, oct_size=cfg.probes.oct_size,
        use_pallas=use_pallas, interpret=interpret,
    )


def build_scene_tri_grid(scene_cpu, resolution: int = 48,
                         cap: int = 24):
    """Build the uniform-grid acceleration structure over the scene's
    WORLD-space triangles (the scene_as.cpp BLAS/TLAS build analog;
    startup task, host-side). Feeds gtao_rt via render_frame's
    tri_grid argument when cfg.gtao.use_ray_query is set."""
    import numpy as _np

    from vkr.scene.accel import build_tri_grid

    pos = _np.asarray(scene_cpu.positions)
    m = _np.asarray(scene_cpu.transforms)[
        _np.asarray(scene_cpu.vert_transform)
    ]
    world = _np.einsum("vij,vj->vi", m[:, :3, :3], pos) + m[:, :3, 3]
    return build_tri_grid(world, _np.asarray(scene_cpu.tri_indices),
                          resolution=resolution, cap=cap)


@functools.lru_cache(maxsize=4)
def _rt_direction_table(count: int):
    from vkr.passes.gtao import ao_ray_directions

    return ao_ray_directions(count)


def compose_probe_reflections(ssr_blurred, rays, probe_rgb):
    """Fill SSR-empty pixels with probe-GI reflections.

    "Empty" is decided by the TRACE's validity channel (rays w = source
    depth, 1.0 = no hit, ssr.py trace docstring), NOT by the blurred color
    being black: a legitimately-black valid reflection survives probe
    compositing. The reference never composes both (probes are not in its
    main loop, trace_probe/shader.comp:73-84); this fill is our extension
    for cfg.enable_probes + enable_ssr (tracked in PARITY.md).
    """
    empty = rays[..., 3:4] >= 1.0
    return jnp.where(empty, probe_rgb, ssr_blurred)


def render_frame(
    scene: SceneDevice,
    state: FrameState,
    cam: CameraFrame,
    ssr_res: SSRResources,
    cfg: RenderConfig,
    *,
    probe_grid=None,
    tri_grid=None,
    use_pallas: bool = True,
    interpret: bool = False,
    tuning: Tuning = None,
):
    """One frame: returns (final color (H, W, 3), new FrameState, aux dict).

    cfg must be static under jit (hash by id: close over it or mark
    static). probe_grid: optional ProbeGrid rendered at startup
    (build_probe_grid); with cfg.enable_probes it feeds indirect
    reflections into deferred shading (BASELINE config 5). tuning:
    optional TRACED Tuning override of the slider scalars (defaults to
    the static cfg values — identical trace)."""
    h, w = cfg.height, cfg.width
    gbuf = add_task(
        "GbufferPass",
        lambda: registry.get("gbuf_opaque_taa")(
            scene, cam.mvp, cam.prev_mvp, cam.jitter,
            width=w, height=h, quantize=cfg.quantize_formats,
            use_pallas=use_pallas, interpret=interpret,
            mask_peel_layers=cfg.raster.mask_peel_layers,
            trilinear=cfg.trilinear_textures,
        ),
    )
    return shade_frame(gbuf, state, cam, ssr_res, cfg,
                       probe_grid=probe_grid, tri_grid=tri_grid,
                       use_pallas=use_pallas, interpret=interpret,
                       tuning=tuning)


def frame_mid(
    gbuf,
    state: FrameState,
    cam: CameraFrame,
    ssr_res: SSRResources,
    cfg: RenderConfig,
    *,
    probe_grid=None,
    tri_grid=None,
    use_pallas: bool = True,
    interpret: bool = False,
    band=None,
    gather_fn=None,
    tuning: Tuning = None,
):
    """The middle of the image-space chain: hi-Z downsample -> SSR
    (trace/filter/blur) -> probe GI -> GTAO (main/filter/accumulate).
    Returns a dict of the products the tail (frame_tail: shading + TAA
    + history) consumes. shade_frame composes both; keeping mid/tail
    independently jittable gives the bench a trustworthy per-group
    timing split and makes .jax_cache entries per-segment (a traced
    edit to the tail no longer recompiles the march).

    band=(row0, band_h) (multi-chip band mode): every EXPENSIVE pass
    computes only its band of rows (full-res rows [row0, row0+band_h),
    half-res [row0//2, ...)); inter-pass arrays are re-replicated by
    gather_fn (an all_gather under shard_map) so each pass sees
    full-frame inputs — windowed passes need no halo logic and the
    result is identical to the single-device frame. row0 may be traced
    (row0 and band_h must be even: half-res chain + velocity quads)."""
    h, w = cfg.height, cfg.width
    t = Tuning.of(cfg) if tuning is None else tuning
    banded = band is not None
    if banded:
        row0, band_h = band
        r0h, bhh = row0 // 2, band_h // 2
        g = gather_fn
    else:
        row0 = band_h = r0h = bhh = None
        g = lambda x: x
    inv_view = _inv4(cam.view)
    prev_inv_view = _inv4(cam.prev_view)
    nm = _normal_mat4(cam.view)

    hiz = add_task(
        "DownsampleGbuffer",
        lambda: registry.get("downsample_hiz")(gbuf.depth, gbuf.normal, gbuf.velocity),
    )
    depth_half = hiz.mips[0]

    # ---- SSR (ssr.run: trace -> filter -> blur) ----
    if cfg.enable_ssr:
        sp = _ssr.SSRParams(
            normal_mat=nm, fovy=cfg.camera.fovy, aspect=cfg.aspect,
            znear=cfg.camera.znear, zfar=cfg.camera.zfar,
            max_roughness=t.ssr_max_roughness,
        )
        pyr = _ssr.pack_pyramid(hiz.mips)
        # the reference's per-frame halton counter: ++ modulo
        # max_accumulated_rays when update_random, else frozen
        # (advanced_ssr.cpp:168-170 / 237-239)
        frame_random = (
            state.frame_index % t.ssr_temporal_rays
            if cfg.ssr.update_random else
            jnp.zeros_like(state.frame_index)
        )
        rays, ssr_occ = add_task(
            "SSSR_trace",
            lambda: registry.get("sssr_trace")(
                pyr, hiz.normal_half, gbuf.material, ssr_res.pdf_lut, sp,
                frame_random, ssr_res.halton,
                max_iterations=cfg.ssr.max_iterations,
                use_pallas=use_pallas, interpret=interpret,
                row0=r0h, band_h=bhh,
            ),
        )
        rays = g(rays)
        ssr_occ = g(ssr_occ)
        reflections = add_task(
            "SSSR_filter",
            lambda: registry.get("sssr_filter")(
                rays, depth_half, gbuf.albedo, hiz.normal_half,
                gbuf.material, sp,
                flags_normalize=cfg.ssr.normalize_filter,
                flags_bilateral=cfg.ssr.bilateral_filter,
                row0=r0h, band_h=bhh,
            ),
        )
        reflections = g(reflections)
        blur_params = _ssr.SSRBlurParams(
            inverse_camera=inv_view, prev_inverse_camera=prev_inv_view,
            fovy=cfg.camera.fovy, aspect=cfg.aspect,
            znear=cfg.camera.znear, zfar=cfg.camera.zfar,
            max_roughness=t.ssr_max_roughness,
            accumulate=cfg.ssr.accumulate,
            disable_blur=not cfg.ssr.use_blur,
        )
        ssr_blurred = add_task(
            "SSSR_blur",
            lambda: registry.get("sssr_blur")(
                reflections, depth_half, hiz.normal_half, gbuf.material,
                state.ssr_history, hiz.velocity_half,
                state.prev_depth_half, blur_params,
                row0=r0h, band_h=bhh,
            ),
        )
    else:
        ssr_occ = None
        ssr_blurred = jnp.zeros(
            (bhh if banded else h // 2, w // 2, 3), jnp.float32)

    # ---- Probe GI -> indirect reflections (BASELINE config 5) ----
    # The reference's ProbeTracePass writes the same RGBA8 reflections
    # image deferred shading consumes (trace_probe/shader.comp:73-84 ->
    # defered_shading/shader.frag:92). With SSR also on, probe hits fill
    # pixels SSR left empty.
    if cfg.enable_probes and probe_grid is not None:
        probe_refl = add_task(
            "TraceProbes",
            lambda: registry.get("trace_probe")(
                depth_half, hiz.normal_half, probe_grid, inv_view,
                cfg.camera.fovy, cfg.aspect, cfg.camera.znear,
                cfg.camera.zfar, row0=r0h, band_h=bhh,
            ),
        )
        probe_rgb = probe_refl[..., :3] * probe_refl[..., 3:4]
        if cfg.enable_ssr:
            ssr_blurred = compose_probe_reflections(
                ssr_blurred, rays, probe_rgb)
        else:
            ssr_blurred = probe_rgb
    ssr_blurred = g(ssr_blurred)

    # ---- GTAO (main -> filter -> accumulate) ----
    if cfg.enable_gtao:
        gp = _gtao.GTAOParams(
            normal_mat=nm, fovy=cfg.camera.fovy, aspect=cfg.aspect,
            znear=cfg.camera.znear, zfar=cfg.camera.zfar,
        )
        base_angle = _gtao.frame_base_angle(state.frame_index)
        dirs = 2 if cfg.gtao.two_directions else 1
        if cfg.gtao.use_ray_query and tri_grid is not None:
            # ray-query GTAO against the scene AS (gtao.cpp:150-196,
            # rt_main.frag) — filter/accumulate run unchanged after it
            rt_dirs = jnp.asarray(
                _rt_direction_table(cfg.gtao.rt_directions))
            raw_ao = g(add_task(
                "GTAO_rt",
                lambda: registry.get("gtao_rt")(
                    depth_half, hiz.normal_half, tri_grid, inv_view,
                    cfg.camera.fovy, cfg.aspect, cfg.camera.znear,
                    cfg.camera.zfar, base_angle, rt_dirs,
                    rt_radius=cfg.gtao.rt_radius, row0=r0h, band_h=bhh,
                ),
            ))
        elif cfg.gtao.mis and ssr_occ is not None:
            # The reference's DEFAULT main-pass mode (gtao.hpp:112
            # mis_gtao = true): MIS-combine one uniform-direction arc
            # with the SSR trace's GGX occlusion estimate (main.cpp:375
            # writes it into gtao.raw before this pass).
            raw_ao = g(add_task(
                "GTAO_main",
                lambda: registry.get("gtao_main_mis")(
                    depth_half, hiz.normal_half, gbuf.material,
                    ssr_res.pdf_lut, ssr_occ, gp, base_angle,
                    weight_ratio=t.weight_ratio,
                    reflections_only=cfg.gtao.reflections_only,
                    row0=r0h, band_h=bhh),
            ))
        else:
            raw_ao = g(add_task(
                "GTAO_main",
                lambda: registry.get("gtao_main")(
                    depth_half, hiz.normal_half, gp, base_angle,
                    dirs, row0=r0h, band_h=bhh),
            ))
        filtered_ao = g(add_task(
            "GTAO_filter",
            lambda: registry.get("gtao_filter")(depth_half, raw_ao,
                                      cfg.camera.znear, cfg.camera.zfar,
                                      row0=r0h, band_h=bhh),
        ))
        ap = _gtao.GTAOAccumParams(
            inverse_camera=inv_view, prev_inverse_camera=prev_inv_view,
            mvp=cam.mvp, fovy=cfg.camera.fovy, aspect=cfg.aspect,
            znear=cfg.camera.znear, zfar=cfg.camera.zfar,
        )
        gtao_accum = g(add_task(
            "GTAO_accumulate",
            lambda: registry.get("gtao_accumulate")(
                depth_half, state.prev_depth_half, filtered_ao,
                hiz.velocity_half, state.gtao_accum, ap,
                state.frame_index == 0,
                row0=r0h, band_h=bhh,
            ),
        ))
        occlusion = gtao_accum[..., 0]
    else:
        gtao_accum = state.gtao_accum
        occlusion = jnp.ones((h // 2, w // 2), jnp.float32)

    return {
        "depth_half": depth_half,
        "ssr_blurred": ssr_blurred,
        "gtao_accum": gtao_accum,
        "occlusion": occlusion,
    }


def frame_tail(
    gbuf,
    mid,
    state: FrameState,
    cam: CameraFrame,
    ssr_res: SSRResources,
    cfg: RenderConfig,
    *,
    band=None,
    gather_fn=None,
    tuning: Tuning = None,
):
    """Deferred shading -> TAA -> end-of-frame history remaps
    (main.cpp:416-420). mid: frame_mid's product dict. Returns
    (final color, new FrameState, aux)."""
    t = Tuning.of(cfg) if tuning is None else tuning
    banded = band is not None
    if banded:
        row0, band_h = band
        g = gather_fn
    else:
        row0 = band_h = None
        g = lambda x: x
    inv_view = _inv4(cam.view)
    prev_inv_view = _inv4(cam.prev_view)
    depth_half = mid["depth_half"]
    ssr_blurred = mid["ssr_blurred"]
    gtao_accum = mid["gtao_accum"]
    occlusion = mid["occlusion"]

    # ---- Deferred shading ----
    shade_params = ShadingParams(
        inverse_camera=inv_view, fovy=cfg.camera.fovy, aspect=cfg.aspect,
        znear=cfg.camera.znear, zfar=cfg.camera.zfar,
        min_roughness=t.shade_min_roughness,
        max_roughness=t.shade_max_roughness,
        show_ao=cfg.show_ao_only,
    )
    color = g(add_task(
        "DeferedShading",
        lambda: registry.get("defered_shading")(
            gbuf, shade_params,
            occlusion=occlusion,
            reflections=ssr_blurred,
            brdf_lut=ssr_res.brdf_lut,
            depth_half=depth_half,
            row0=row0, band_h=band_h,
        ),
    ))

    # ---- TAA ----
    if cfg.enable_taa:
        tp = _taa.TAAParams(
            inverse_camera=inv_view, prev_inverse_camera=prev_inv_view,
            fovy=cfg.camera.fovy, aspect=cfg.aspect,
            znear=cfg.camera.znear, zfar=cfg.camera.zfar,
        )
        final = g(add_task(
            "TAA",
            lambda: registry.get("taa_resolve")(
                state.taa_history, state.prev_depth, gbuf.depth,
                gbuf.velocity, color, tp,
                row0=row0, band_h=band_h,
            ),
        ))
    else:
        final = color

    # ---- history remaps (main.cpp:416-420) ----
    new_state = state.replace(
        prev_depth=gbuf.depth,
        prev_depth_half=depth_half,
        taa_history=final,
        gtao_accum=gtao_accum,
        gtao_prev=occlusion,
        ssr_history=ssr_blurred,
        prev_mvp=cam.mvp,
        frame_index=state.frame_index + 1,
    )
    aux = {"gbuffer": gbuf, "hiz_depth": depth_half,
           "ssr": ssr_blurred, "ao": occlusion,
           "overflow": gbuf.overflow}
    return final, new_state, aux


def shade_frame(
    gbuf,
    state: FrameState,
    cam: CameraFrame,
    ssr_res: SSRResources,
    cfg: RenderConfig,
    *,
    probe_grid=None,
    tri_grid=None,
    use_pallas: bool = True,
    interpret: bool = False,
    band=None,
    gather_fn=None,
    tuning: Tuning = None,
):
    """The image-space chain after the G-buffer (hi-Z -> SSR -> GTAO ->
    shading -> TAA -> history) = frame_mid . frame_tail. Split out so
    the band-parallel frame (parallel/band.py) can feed it a gathered
    full-frame G-buffer; see frame_mid's docstring for band semantics."""
    mid = frame_mid(
        gbuf, state, cam, ssr_res, cfg, probe_grid=probe_grid,
        tri_grid=tri_grid, use_pallas=use_pallas, interpret=interpret,
        band=band, gather_fn=gather_fn, tuning=tuning,
    )
    return frame_tail(
        gbuf, mid, state, cam, ssr_res, cfg, band=band,
        gather_fn=gather_fn, tuning=tuning,
    )


def _inv4(view):
    """Inverse of a rigid view matrix, traced-compatible."""
    r = view[:3, :3]
    t = view[:3, 3]
    top = jnp.concatenate([r.T, -apply_linear(t, r.T)[:, None]], axis=1)
    return jnp.concatenate(
        [top, jnp.asarray([[0.0, 0.0, 0.0, 1.0]])], axis=0
    )


def _normal_mat4(view):
    """transpose(inverse(view)) for a rigid view = rotation part unchanged,
    as a 4x4 (main.cpp:377)."""
    inv = _inv4(view)
    return inv.T
