"""PyTorch ops of the dense stereo pipeline (counterparts of
``stereo_matching_cuda_tpu.ops``).

Plain functions on tensors, float32 throughout, batched over the
disparity axis.  Where the reference computes in float64 (grayscale
weights, the guided filter's 1/(var+EPS)) the ops do so natively.  The
hand-written CUDA kernels live behind ``fused_guided.guided_wta_fused``
and ``fused_post.lr_fill_fused``.
"""

from .image import rgb_to_grayscale, fl_to_ch, x_derivative
from .boxfilter import integral_image, box_mean, window_area
from .cost import cost_volume
from .guided import guided_filter_wta, streaming_wta, BEST_COST_INIT
from .occlusion import detect_occlusion, fill_occlusion

__all__ = [
    "streaming_wta",
    "rgb_to_grayscale",
    "fl_to_ch",
    "x_derivative",
    "integral_image",
    "box_mean",
    "window_area",
    "cost_volume",
    "guided_filter_wta",
    "BEST_COST_INIT",
    "detect_occlusion",
    "fill_occlusion",
]
