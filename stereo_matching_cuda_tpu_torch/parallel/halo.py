"""Halo exchange over a mesh axis with point-to-point sends
(counterpart of ``stereo_matching_cuda_tpu/parallel/halo.py``).

Non-periodic: the ranks at the ends of the axis get ZEROS in the halo
beyond the mesh.  Zero out-of-image halos are what the sharded stereo
math wants: a zero-padded window sum over the clamped window equals the
reference's conditional 4-tap sum (guidedFilter.cu:305-318), so border
tiles need nothing beyond the global-coordinate area normalizer.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def halo_exchange(t: torch.Tensor, halo: int, mesh: DeviceMesh, axis: str,
                  dim: int) -> torch.Tensor:
    """``t`` extended by ``halo`` on both sides of ``dim``: the last
    ``halo`` slices of the previous rank along ``axis`` before it, the
    first ``halo`` of the next rank after it.  Every rank of the axis
    calls it together."""
    if halo == 0:
        return t
    if t.shape[dim] < halo:
        raise ValueError(f"local dim {t.shape[dim]} smaller than halo {halo}")
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    # contiguous strips of t's dtype: point-to-point sends need both
    last = t.narrow(dim, t.shape[dim] - halo, halo).contiguous()
    first = t.narrow(dim, 0, halo).contiguous()
    left = torch.zeros_like(last)
    right = torch.zeros_like(first)
    if n > 1:
        group = mesh.get_group(axis)
        me = mesh.get_local_rank(axis)
        ops = []
        if me + 1 < n:        # my last strip is the next rank's left halo
            peer = dist.get_global_rank(group, me + 1)
            ops += [dist.P2POp(dist.isend, last, peer, group),
                    dist.P2POp(dist.irecv, right, peer, group)]
        if me > 0:            # my first strip is the previous rank's right halo
            peer = dist.get_global_rank(group, me - 1)
            ops += [dist.P2POp(dist.isend, first, peer, group),
                    dist.P2POp(dist.irecv, left, peer, group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return torch.cat([left, t, right], dim=dim)
