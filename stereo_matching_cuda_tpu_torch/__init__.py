"""PyTorch/CUDA port of the dense stereo engine.

The JAX package ``stereo_matching_cuda_tpu`` is the reference; this
package computes the same functions with PyTorch, and its hand-written
Hopper kernels (``csrc/``) take the place of the TPU kernels on the main
path and the dual-view path.  It never imports JAX.

Layout (each module mirrors its JAX counterpart):
  config     — frozen StereoConfig (reference #defines as defaults)
  ops        — plain tensor ops, batched over disparity; fused_guided
               (kernels K1, K4, K5) and fused_post (kernel K2) with their
               plain versions
  pipeline   — end-to-end pipeline and the numpy host entry
  metrics    — bad-N / EPE
  utils      — synthetic scenes with exact ground truth
"""

from .config import StereoConfig, DEFAULT_CONFIG  # noqa: F401
from .pipeline import compute_disparity  # noqa: F401

__version__ = "0.1.0"
