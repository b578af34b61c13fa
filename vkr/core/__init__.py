from vkr.core.formats import (
    quantize_d24,
    quantize_unorm,
    srgb_to_linear,
    linear_to_srgb,
    quantize_f16,
)
from vkr.core.framestate import FrameState
