"""Device meshes over torch.distributed, and the halo the sharded
pipeline needs (counterpart of ``stereo_matching_cuda_tpu/parallel/mesh.py``)."""

from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..config import StereoConfig

# The mesh's dimensions, outermost first, in the JAX package's order.
AXES = ("b", "d", "y", "x")


def make_mesh(b: int = 1, y: int = 1, x: int = 1, d: int = 1,
              device_type: str = "cuda") -> DeviceMesh:
    """Mesh over ('b','d','y','x') = batch × disparity-range × tile-row ×
    tile-col, one rank per device, over the initialized process group.

    'x' is innermost, so the x-halo exchanges (the most frequent
    collective: the disparity shift and the LR check reach along
    epipolar lines) run between neighbouring ranks; the 'd' axis carries
    only the all_gather of per-range (best, dmap) pairs.  Every rank
    builds its meshes in the same order (the sub-groups are made
    collectively).  Raises ValueError unless the world has exactly
    b*d*y*x ranks.
    """
    n = b * d * y * x
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != n:
        raise ValueError(f"need {n} devices, have {have} (ranks of the process group)")
    return init_device_mesh(device_type, (b, d, y, x), mesh_dim_names=AXES)


def axis_sizes(mesh: DeviceMesh) -> dict:
    """{axis name: size} of a mesh made by ``make_mesh``."""
    return {name: mesh.size(i) for i, name in enumerate(mesh.mesh_dim_names)}


def pipeline_halo(cfg: StereoConfig) -> tuple[int, int]:
    """(halo_y, halo_x) needed so a tile+halo region contains every
    input of the full per-pixel pipeline:

      x: max |d| disparity shift (cost volume reads I2[x+d],
         costVolume.cu:187) + 1 (x-derivative stencil, costVolume.cu:364)
         + 2·(R+1) (two chained box filters: q = box(a(box(p))),
         guidedFilter.cu:171-238)
      y: 2·(R+1)
    """
    box2 = 2 * (cfg.radius + 1)
    return box2, cfg.shift_max + 1 + box2
