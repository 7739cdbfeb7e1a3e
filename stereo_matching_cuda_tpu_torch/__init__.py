"""PyTorch/CUDA port of the dense stereo engine.

The JAX package ``stereo_matching_cuda_tpu`` is the reference; this
package computes the same functions with PyTorch, and its hand-written
Hopper kernels (``csrc/``) take the place of every TPU kernel of the
JAX package's single-view, dual-view and batch paths.  It never imports
JAX.

Layout (each module mirrors its JAX counterpart):
  config     — frozen StereoConfig (reference #defines as defaults)
  ops        — plain tensor ops, batched over disparity; fused_guided
               (kernels K1, K3, K4, K5) and fused_post (kernel K2) with
               their plain versions
  pipeline   — end-to-end pipeline, its batch form and the numpy host
               entries
  models     — the guided and box matchers (nn.Module)
  metrics    — bad-N / EPE / occlusion count
  evaluate   — dataset scoring (Middlebury layout)
  profiling  — per-stage table, per-kernel device split, trace
  cli        — ``python -m stereo_matching_cuda_tpu_torch`` (--eval,
               --profile, --serve, --sequence)
  serve      — the micro-batching HTTP server
  utils      — image codecs and I/O, synthetic scenes with exact ground
               truth
"""

from .config import StereoConfig, DEFAULT_CONFIG  # noqa: F401
from .pipeline import (  # noqa: F401
    compute_disparity, compute_disparity_stacked, stereo_pipeline,
    stereo_pipeline_batch)
from .models import (  # noqa: F401
    BoxStereoMatcher, GuidedStereoMatcher, StereoMatcher)

__version__ = "0.1.0"
