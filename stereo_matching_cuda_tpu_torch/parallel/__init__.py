"""Multi-device execution layer of the port: device meshes, halo
exchange and the sharded stereo pipeline over torch.distributed
(counterpart of ``stereo_matching_cuda_tpu/parallel``).

The reference is strictly single-GPU (cudaSetDevice(0), main.cu:44-48).
A ``DeviceMesh`` over the axes

  ('b', 'd', 'y', 'x')   batch × disparity range × tile rows × tile columns

has one rank per device (NCCL on the card, gloo on the CPU).  Halos for
the stencil reach of the pipeline (disparity shift + derivative + two
box-filter radii) are exchanged point to point, the disparity ranges are
combined over an all_gather, and the cross-tile occlusion fill is a
two-level scan over an all_gather of per-tile summaries.
"""

from .mesh import make_mesh, pipeline_halo
from .halo import halo_exchange
from .sharded import sharded_stereo_pipeline
from .multihost import initialize, pod_mesh, from_host_batches

__all__ = [
    "make_mesh",
    "pipeline_halo",
    "halo_exchange",
    "sharded_stereo_pipeline",
    "initialize",
    "pod_mesh",
    "from_host_batches",
]
