"""Configuration of the PyTorch/CUDA stereo engine.

The counterpart of ``stereo_matching_cuda_tpu/config.py``: the reference
tunables (``SystemIncludes.h:6-24``) with the same defaults, plus the
framework fields that change results or routing.  ``dual_view`` and
``stream`` route the kernel path to different kernels: one kernel per
view (K3 tiled, or K1 row-walking with ``stream=True``) or both views in
one pass (K4 tiled, K5 row-walking).  The other TPU scheduling knobs of the
JAX config (staged, unroll_max, y_sum, slice_group, vmem_mb,
sw_pipeline, dma_buffer) are not carried: none of them changes the
function computed or the kernel run.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class StereoConfig:
    """All tunables of the stereo pipeline (frozen, hashable)."""

    # Grayscale weights (SystemIncludes.h:7-9; blue is 0.0721, not 0.114).
    r_w: float = 0.299
    g_w: float = 0.587
    b_w: float = 0.0721

    # Cost blend & truncation (SystemIncludes.h:10,13-14).
    alpha: float = 0.9
    th_color: float = 7.0
    th_grad: float = 2.0

    # Disparity search range, inclusive (SystemIncludes.h:11-12).
    d_min: int = -15
    d_max: int = 0

    # Guided filter (SystemIncludes.h:21,23).
    radius: int = 9
    eps: float = 6.5025

    # Left-right consistency tolerance (SystemIncludes.h:24).
    d_lr: int = 0

    # --- framework fields (no reference equivalent) --------------------
    # Disparity slices aggregated per step on the plain path (bounds peak
    # memory for wide ranges).  None = all at once.  The kernel path
    # never materializes the volume, so it has nothing to chunk.
    d_chunk: Optional[int] = None
    # Parity mode: integral images with the reference's sequential
    # float32 association (integral.cu:78-131).  Bit-exact vs the
    # oracle, serial — for validation, not production.
    exact_integral: bool = False
    # Hand-written CUDA matching kernel (ops/fused_guided.py) instead of
    # the plain op-by-op path.  "auto" = on CUDA tensors outside parity
    # mode; True forces (CUDA tensors only); False never.
    fused: str | bool = "auto"
    # Both views in one kernel pass (ops/fused_guided.py
    # guided_wta_fused_dual: shared input windows and raw cost slice).
    # "auto" = when the kernel path runs and size_d <= 8; True forces;
    # False always runs one single-view kernel per view (K3, or K1 with
    # stream=True).
    dual_view: str | bool = "auto"
    # Row walk or tiles.  Dual route: True = K5 (row walk down a band, the
    # 2R y-halo paid once per band), False = K4 (tiles with their halo
    # recomputed), None = K5 from 200,000 px when it fits one block's
    # shared memory.  Single-view route: True = K1 (row walk), False or
    # None = K3 (tiles; pipeline.use_stream).
    stream: Optional[bool] = None
    # CUDA post kernel (ops/fused_post.py: LR check + occlusion fill).
    # None follows the matching path; bit-identical either way.
    post_fused: Optional[bool] = None

    def __post_init__(self):
        if self.d_max < self.d_min:
            raise ValueError(f"d_max {self.d_max} < d_min {self.d_min}")
        if self.radius < 1:
            raise ValueError(f"radius must be >= 1, got {self.radius}")
        if self.eps <= 0:
            raise ValueError(f"eps must be > 0, got {self.eps}")
        if self.th_color < 0 or self.th_grad < 0:
            raise ValueError("truncation thresholds must be >= 0")
        if self.d_chunk is not None and (
            self.d_chunk < 1 or self.size_d % self.d_chunk
        ):
            raise ValueError(
                f"d_chunk {self.d_chunk} must divide size_d {self.size_d}")
        if self.fused not in (True, False, "auto"):
            raise ValueError(
                f"fused must be True, False or 'auto', got {self.fused!r}")
        if self.dual_view not in (True, False, "auto"):
            raise ValueError(
                f"dual_view must be True, False or 'auto', got {self.dual_view!r}")
        if self.stream not in (None, True, False):
            raise ValueError(
                f"stream must be None, True or False, got {self.stream!r}")
        if self.post_fused not in (None, True, False):
            raise ValueError(
                f"post_fused must be None, True or False, "
                f"got {self.post_fused!r}")
        if self.fused is True and self.exact_integral:
            raise ValueError(
                "fused=True and exact_integral=True are mutually exclusive: "
                "the fused kernel is the fast path (WTA ties may flip)")

    @property
    def size_d(self) -> int:
        """Number of disparity hypotheses (main.cu:70)."""
        return self.d_max - self.d_min + 1

    @property
    def d_min_right(self) -> int:
        """Label offset of the right view: labels are d_min_right + s
        (main.cu:81-82)."""
        return -self.d_max

    @property
    def d_occlusion(self) -> int:
        """Sentinel written into LR-inconsistent pixels (main.cu:149)."""
        return self.d_min - 100

    @property
    def v_min(self) -> int:
        """Occlusion-fill validity threshold (main.cu:154)."""
        return self.d_min

    @property
    def window(self) -> int:
        """Box window edge length."""
        return 2 * self.radius + 1

    @property
    def shift_max(self) -> int:
        """Largest |disparity| either view samples at."""
        return max(abs(self.d_min), abs(self.d_max))

    def disparities(self, dmin: Optional[int] = None) -> Tuple[int, ...]:
        base = self.d_min if dmin is None else dmin
        return tuple(base + s for s in range(self.size_d))


DEFAULT_CONFIG = StereoConfig()


def config_from_jax(cfg) -> StereoConfig:
    """The port's config from a JAX-package ``StereoConfig``: every field
    this class has, read by attribute name (duck-typed, so this module
    never imports JAX).  The system has no weights; this is the whole
    state carried across."""
    return StereoConfig(**{f.name: getattr(cfg, f.name)
                           for f in dataclasses.fields(StereoConfig)})
