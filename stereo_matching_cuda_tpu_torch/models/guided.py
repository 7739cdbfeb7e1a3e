"""The flagship guided-filter matcher (the reference pipeline)."""

from __future__ import annotations

from ..pipeline import stereo_pipeline
from .base import StereoMatcher


class GuidedStereoMatcher(StereoMatcher):
    """Guided-filter cost aggregation (guidedFilter.cu semantics): the
    hand-written kernels on CUDA, exact parity mode via
    cfg.exact_integral."""

    def _forward(self, left, right) -> dict:
        return stereo_pipeline(left, right, self.cfg)
