"""Several processes and hosts: the process group and host-local frame
feeding (counterpart of ``stereo_matching_cuda_tpu/parallel/multihost.py``).

One rank per device.  Each host decodes its own frames; the mesh puts
the 'b' axis across hosts (frames never cross hosts) and keeps 'd', 'y'
and 'x' within a host's devices, so the halo exchanges and the WTA
combine stay on the host's links.  A launcher (``torchrun``) sets
``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT`` and
``LOCAL_WORLD_SIZE``; ranks of one host are consecutive.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import socket

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .mesh import make_mesh

_LAUNCHER_VARS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def _default_backend() -> str:
    return "nccl" if torch.cuda.is_available() else "gloo"


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str | None = None) -> None:
    """``torch.distributed.init_process_group`` for this process; a no-op
    for a single process.

    ``num_processes`` <= 1 is a no-op.  With no arguments the group comes
    from a launcher's environment (``env://``), and the call is a no-op
    when none of its variables is set; a partial set raises.  With
    explicit arguments (``coordinator_address`` "host:port") every
    failure propagates: a half-failed cluster init must not degrade to a
    single process.  ``backend`` defaults to NCCL where CUDA is
    available, gloo otherwise; with NCCL each rank takes the device of
    its ``LOCAL_RANK`` (its rank modulo the devices when unset)."""
    if num_processes is not None and num_processes <= 1:
        return
    if coordinator_address is None and num_processes is None:
        if not any(k in os.environ for k in _LAUNCHER_VARS):
            return
        init_method = "env://"
    else:
        init_method = f"tcp://{coordinator_address}" if coordinator_address else "env://"
    backend = backend or _default_backend()
    dist.init_process_group(
        backend, init_method=init_method,
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id)
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get(
            "LOCAL_RANK", dist.get_rank() % torch.cuda.device_count())))


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def process_group(backend: str | None = None):
    """The process group of a run: the one already open, else
    ``initialize()``'s from a launcher, else a one-rank group of this
    lone process on localhost.  A group this opened is destroyed on
    exit."""
    if dist.is_initialized():
        yield
        return
    initialize(backend=backend)
    if not dist.is_initialized():
        dist.init_process_group(backend or _default_backend(),
                                init_method=f"tcp://127.0.0.1:{free_port()}",
                                world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _hosts() -> tuple[int, int]:
    """(number of hosts, this rank's host): ``LOCAL_WORLD_SIZE`` ranks a
    host, all of them on one when it is unset."""
    world = dist.get_world_size()
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if per_host < 1 or world % per_host:
        raise ValueError(f"LOCAL_WORLD_SIZE {per_host} does not divide the world {world}")
    return world // per_host, dist.get_rank() // per_host


def pod_mesh(frames_per_host: int = 1, y: int = 1, x: int = 1, d: int = 1,
             device_type: str = "cuda") -> DeviceMesh:
    """Mesh over every rank of every host, with the 'b' axis sized
    hosts * frames_per_host so that batch parallelism spans the hosts."""
    hosts, _ = _hosts()
    b = hosts * frames_per_host
    need = b * y * x * d
    if need != dist.get_world_size():
        raise ValueError(f"mesh {b}x{d}x{y}x{x} = {need} devices != available "
                         f"{dist.get_world_size()}")
    return make_mesh(b, y, x, d, device_type)


@dataclasses.dataclass(frozen=True)
class HostFrames:
    """The frames of a global (batch, H, W, C) batch that one rank's 'b'
    coordinate owns (``from_host_batches``); ``sharded_stereo_pipeline``
    takes it in place of the whole batch."""

    frames: np.ndarray | torch.Tensor    # (batch / b, H, W, C)
    batch: int                           # frames of the global batch


def from_host_batches(mesh: DeviceMesh, local_left, local_right):
    """Each rank's share of a global batch made of every host's local
    (n, H, W, C) frames, host by host, without gathering them: the frames
    its 'b' coordinate owns, as ``HostFrames`` pairs."""
    hosts, host = _hosts()
    n_local = local_left.shape[0]
    if local_right.shape != local_left.shape:
        raise ValueError(f"left {local_left.shape} and right {local_right.shape} differ")
    nb = mesh.size(mesh.mesh_dim_names.index("b"))
    batch = n_local * hosts
    if batch % nb:
        raise ValueError(f"batch {batch} not divisible by the mesh's b axis {nb}")
    per = batch // nb
    start = mesh.get_local_rank("b") * per - host * n_local
    if start < 0 or start + per > n_local:
        raise ValueError("the frames of this rank's b coordinate are on another host")
    return (HostFrames(local_left[start:start + per], batch),
            HostFrames(local_right[start:start + per], batch))
