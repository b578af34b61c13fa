"""Golden-image regression tests (SURVEY.md §4 rebuild implication:
golden-image tests per pass).

Full-pipeline renders of the two test scenes compared against stored
goldens (tests/goldens/, generated on the CPU backend by this same
pipeline). Regenerate with tests/regen_goldens.py after INTENTIONAL
visual changes — a PSNR drop here means a rendering change, wanted or not.
"""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "goldens")


def psnr(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64))
                  ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(1.0 / mse)


def load_golden(name):
    from PIL import Image

    img = np.asarray(
        Image.open(os.path.join(GOLDEN_DIR, name)), np.float32
    ) / 255.0
    return img


def render_scene(scene_cpu, eye, center, frames=3):
    from vkr.config import RenderConfig
    from vkr.core.framestate import FrameState
    from vkr.frame import (build_ssr_resources, camera_frame,
                               render_frame)
    from vkr.mathlib import look_at
    from vkr.passes.gbuffer import upload_scene

    cfg = RenderConfig(width=128, height=128)
    cfg = dataclasses.replace(
        cfg, ssr=dataclasses.replace(cfg.ssr, max_iterations=24)
    )
    scene = upload_scene(scene_cpu)
    res = build_ssr_resources(64)
    view = look_at(eye, center, (0, -1, 0))
    state = FrameState.initial(128, 128)
    f = jax.jit(
        lambda s, st, c: render_frame(s, st, c, res, cfg,
                                      use_pallas=True, interpret=True)
    )
    for i in range(frames):
        cam = camera_frame(cfg, view, view, i)
        color, state, aux = f(scene, state, cam)
    return color, aux


def srgb(x):
    x = np.clip(np.asarray(x), 0, 1)
    return np.where(x <= 0.0031308, x * 12.92,
                    1.055 * x ** (1 / 2.4) - 0.055)


CASES = {
    "suzanne": dict(
        path="/root/reference/assets/gltf/suzanne/Suzanne.gltf",
        eye=(0, 0.3, 2.6), center=(0, 0, 0), tex=128,
    ),
    "colonnade": dict(
        eye=(-6, 2.2, -2), center=(4, 1.8, 0.5), tex=64,
    ),
}


@pytest.mark.parametrize("case", list(CASES))
def test_golden(case):
    from vkr.scene import colonnade_scene, load_scene

    c = CASES[case]
    if "path" in c:
        scene = load_scene(c["path"], tex_size=c["tex"])
    else:
        scene = colonnade_scene(columns=3, tessellation=10,
                                tex_size=c["tex"])
    color, aux = render_scene(scene, c["eye"], c["center"])

    checks = {
        f"{case}_color.png": srgb(color),
        f"{case}_albedo.png": srgb(aux["gbuffer"].albedo[..., :3]),
        f"{case}_ao.png": np.asarray(aux["ao"]),
    }
    for name, img in checks.items():
        golden = load_golden(name)
        if golden.ndim == 3 and img.ndim == 2:
            img = np.repeat(img[..., None], golden.shape[-1], -1)
        p = psnr(img, golden)
        # 8-bit quantized golden: identical pipelines score ~50+; 40 is
        # BASELINE.json's quality bar (allows numeric drift, catches
        # visual changes).
        assert p > 40.0, f"{name}: PSNR {p:.1f} dB vs golden"


class TestMaskDepthPeel:
    def test_two_stacked_masked_layers(self):
        """mask_peel_layers=2: a hole in the front masked surface reveals
        the masked surface BEHIND it (not the opaque floor), closing the
        one-layer gap vs the reference's per-fragment discard
        (opaque_taa.frag:32-34)."""
        import numpy as np
        import jax.numpy as jnp

        from vkr.mathlib import look_at, perspective
        from vkr.passes.gbuffer import render_gbuffer, upload_scene
        from vkr.scene.procedural import two_masked_quads_scene

        scene_cpu = two_masked_quads_scene()
        scene = upload_scene(scene_cpu)
        view = look_at((0, 0, -4), (0, 0, 1), (0, -1, 0))
        proj = perspective(np.radians(60), 1.0, 0.05, 80.0)
        vp = jnp.asarray(proj @ view)

        g1 = render_gbuffer(scene, vp, vp, jnp.zeros(2), width=64,
                            height=64, use_pallas=False, quantize=False,
                            mask_peel_layers=1)
        g2 = render_gbuffer(scene, vp, vp, jnp.zeros(2), width=64,
                            height=64, use_pallas=False, quantize=False,
                            mask_peel_layers=2)
        # center pixels: front quad's hole; back quad is opaque-alpha there
        m1 = np.asarray(g1.material[28:36, 28:36, 2])
        m2 = np.asarray(g2.material[28:36, 28:36, 2])
        # with one layer the hole falls through to the floor material;
        # with two layers it lands on the back masked quad's material
        assert not np.allclose(m1, m2)
        d1 = np.asarray(g1.depth[28:36, 28:36])
        d2 = np.asarray(g2.depth[28:36, 28:36])
        assert (d2 <= d1 + 1e-6).all() and (d2 < d1 - 1e-6).any()
