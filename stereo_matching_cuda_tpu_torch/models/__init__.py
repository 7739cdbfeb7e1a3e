"""Model families: stereo matchers sharing the cost-volume front end
(counterpart of ``stereo_matching_cuda_tpu/models``).

  * GuidedStereoMatcher — the flagship: guided-filter aggregation,
    the hand-written kernels on CUDA, bit-exact parity mode.
  * BoxStereoMatcher — plain box-mean cost aggregation (the classic
    SAD+box baseline), sharing the cost volume, WTA rule, LR check and
    occlusion fill.
"""

from .base import StereoMatcher
from .guided import GuidedStereoMatcher
from .box import BoxStereoMatcher, box_stereo_pipeline

__all__ = ["StereoMatcher", "GuidedStereoMatcher", "BoxStereoMatcher",
           "box_stereo_pipeline"]
