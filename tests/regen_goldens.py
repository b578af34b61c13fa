"""Regenerate tests/goldens/ after intentional visual changes:

    VKR_PLATFORM=cpu python tests/regen_goldens.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("VKR_PLATFORM", "cpu")

from vkr.core.platform import ensure_platform

ensure_platform()

import numpy as np

from vkr.core.readback import save_png
from tests.test_golden import CASES, GOLDEN_DIR, render_scene, srgb


def main():
    from vkr.scene import colonnade_scene, load_scene

    for case, c in CASES.items():
        if "path" in c:
            scene = load_scene(c["path"], tex_size=c["tex"])
        else:
            scene = colonnade_scene(columns=3, tessellation=10,
                                    tex_size=c["tex"])
        color, aux = render_scene(scene, c["eye"], c["center"])
        save_png(np.asarray(srgb(color)),
                 os.path.join(GOLDEN_DIR, f"{case}_color.png"))
        save_png(np.asarray(srgb(aux["gbuffer"].albedo[..., :3])),
                 os.path.join(GOLDEN_DIR, f"{case}_albedo.png"))
        save_png(np.asarray(aux["ao"]),
                 os.path.join(GOLDEN_DIR, f"{case}_ao.png"))
        print("regenerated", case)


if __name__ == "__main__":
    main()
