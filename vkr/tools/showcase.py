"""Showcase capture: dolly through the colonnade on the GPU and write
docs/colonnade_orbit.gif + docs/colonnade_final.png (converged still).

    python -m vkr.tools.showcase
"""
import os
import time
import numpy as np
from vkr.core.platform import ensure_platform, pallas_interpret
print("backend:", ensure_platform())
DOCS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "docs")
import dataclasses
import jax
from PIL import Image
from vkr.config import RenderConfig
from vkr.core.framestate import FrameState
from vkr.core.formats import linear_to_srgb
from vkr.frame import build_ssr_resources, camera_frame, render_frame
from vkr.mathlib import look_at
from vkr.passes.gbuffer import upload_scene
from vkr.scene import colonnade_scene

W, H = 1920, 1080
cfg = RenderConfig(width=W, height=H)
scene = upload_scene(colonnade_scene(columns=16, tessellation=64, tex_size=512))
res = build_ssr_resources(1024)
jitted = jax.jit(lambda s, st, c: render_frame(s, st, c, res, cfg,
                                               use_pallas=True,
                                               interpret=pallas_interpret()),
                 donate_argnums=(1,))
eye = np.array([-18.0, 2.2, -2.0], np.float32)
center = np.array([4.0, 1.8, 0.5], np.float32)

def view_at(i):
    # slow dolly down the hall; hold still for the last frames so the
    # temporal passes converge for the final still
    t = min(i, 56)
    e = eye + np.array([0.12 * t, 0.0, 0.3 * np.sin(0.05 * t)],
                       np.float32)
    c = center + np.array([0.12 * t, 0.0, 0.0], np.float32)
    return look_at(e, c, (0, -1, 0))

state = FrameState.initial(H, W)
view = prev = view_at(0)
frames = []
t0 = time.time()
N = 72
for i in range(N):
    prev, view = view, view_at(i)
    cam = camera_frame(cfg, view, prev, i)
    color, state, aux = jitted(scene, state, cam)
    if i >= 8:  # let TAA/SSR converge before capturing
        rgb = np.clip(np.asarray(linear_to_srgb(color)) * 255, 0,
                      255).astype(np.uint8)
        frames.append(rgb)
print(f"{N} frames in {time.time()-t0:.0f}s", flush=True)
Image.fromarray(frames[-1]).save(os.path.join(DOCS, "colonnade_final.png"))
small = [Image.fromarray(f).resize((640, 360), Image.LANCZOS)
         for f in frames[::2]]
small[0].save(os.path.join(DOCS, "colonnade_orbit.gif"), save_all=True,
              append_images=small[1:], duration=66, loop=0)
print("saved docs/colonnade_orbit.gif +", len(small), "frames", flush=True)
