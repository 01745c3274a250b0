"""Multi-process scale-out: processes carry batches, never DSP state.

Port of airwave_tpu/parallel/multihost.py on torch.distributed. Per-stream
carries stay on their shard's device, so scaling over processes is data
placement: each process feeds the streams that live on its devices, and no
collective runs in the steady state of a stream-sharded step (a
speaker-sharded row that spans processes sums its partial mixes with one
all_reduce a block; parallel/mesh.py). This module provides:

  - `initialize()`: torch.distributed bootstrap (address, world, rank and
    backend all given by the caller; one process does nothing)
  - `global_mesh()`: a streams mesh over every process's devices, in rank
    order, each device tagged with its process
  - `HostShardSpec` / `host_shard_spec()`: which global stream rows this
    process owns and feeds
  - `make_global_array()`: the Sharded [B_global, ...] input from this
    process's rows, one part per local device

The backend is never guessed: `gloo` on the CPU, and for several processes
sharing one card (NCCL refuses two ranks on one GPU); `nccl` for one
process per card.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from airwave_tpu_torch.device import resolve_device
from airwave_tpu_torch.parallel.mesh import (STREAMS, Mesh, Sharded,
                                             make_mesh, process_index)

BACKENDS = ("gloo", "nccl")


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> None:
    """torch.distributed.init_process_group over TCP at
    `coordinator_address` ("host:port", or a "tcp://" URL); a no-op for one
    process. `backend` is "gloo" or "nccl" (module docstring)."""
    if num_processes is None or num_processes <= 1:
        return
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}: "
                         f"gloo on the CPU or for processes sharing a card, "
                         f"nccl for one process per card")
    if coordinator_address is None or process_id is None:
        raise ValueError("a multi-process run needs coordinator_address and "
                         "process_id")
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    torch.distributed.init_process_group(backend=backend, init_method=url,
                                         world_size=int(num_processes),
                                         rank=int(process_id))


def process_count() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def global_mesh(axis_name: str = STREAMS,
                devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D mesh of every process's devices in rank order (this process's
    `devices`, every visible card by default), each device tagged with the
    process that holds it (all_gather_object of their names)."""
    local = [str(d) for d in make_mesh(devices).devices.ravel()]
    if process_count() > 1:
        gathered = [None] * process_count()
        torch.distributed.all_gather_object(gathered, local)
    else:
        gathered = [local]
    names, procs = [], []
    for rank, theirs in enumerate(gathered):
        names += theirs
        procs += [rank] * len(theirs)
    arr = np.empty(len(names), dtype=object)
    arr[:] = [torch.device(n) for n in names]
    return Mesh(arr, (axis_name,), np.asarray(procs, np.int64))


@dataclasses.dataclass(frozen=True)
class HostShardSpec:
    """This process's slice of the global stream axis."""

    global_batch: int
    local_start: int
    local_count: int

    @property
    def local_slice(self) -> slice:
        return slice(self.local_start, self.local_start + self.local_count)


def _local_axis_coords(mesh: Mesh, axis_name: str) -> list:
    """Sorted coordinates along `axis_name` that this process's devices
    cover (on a multi-axis mesh the batch is sharded over this axis only
    and replicated over the others)."""
    ax = mesh.axis(axis_name)
    me = process_index()
    coords = sorted({idx[ax] for idx, p in np.ndenumerate(mesh.process_index)
                     if p == me})
    if not coords:
        raise ValueError("mesh contains no device of this process")
    # Contiguity assumption: a process's axis coordinates are consecutive.
    if coords[-1] - coords[0] + 1 != len(coords):
        raise ValueError(f"this process's {axis_name} coordinates {coords} "
                         f"are not contiguous")
    return coords


def host_shard_spec(global_batch: int, mesh: Mesh,
                    axis_name: str = STREAMS) -> HostShardSpec:
    """Rows this process feeds: the contiguous block mapped to its devices'
    coordinates along `axis_name` (the global split is row-contiguous over
    that axis; other mesh axes replicate)."""
    axis_size = mesh.shape[axis_name]
    if global_batch % axis_size:
        raise ValueError(f"global batch {global_batch} does not divide by the "
                         f"{axis_size} {axis_name} coordinates")
    per_coord = global_batch // axis_size
    coords = _local_axis_coords(mesh, axis_name)
    return HostShardSpec(global_batch, coords[0] * per_coord,
                         len(coords) * per_coord)


def make_global_array(local_rows, spec: HostShardSpec, mesh: Mesh,
                      axis_name: str = STREAMS) -> Sharded:
    """The global [B_global, ...] input as this process's parts: each local
    device gets the contiguous row block of its `axis_name` coordinate
    (replicas along other mesh axes get the same block), on that device.
    The result feeds the stream-sharded steps directly."""
    rows = (local_rows if isinstance(local_rows, torch.Tensor)
            else torch.as_tensor(np.asarray(local_rows)))
    if rows.shape[0] != spec.local_count:
        raise ValueError(f"{rows.shape[0]} local rows, the spec owns "
                         f"{spec.local_count}")
    ax = mesh.axis(axis_name)
    per_coord = spec.global_batch // mesh.shape[axis_name]
    me = process_index()
    parts, starts = [], []
    for idx, device in np.ndenumerate(mesh.devices):
        if mesh.process_index[idx] != me:
            continue
        start = idx[ax] * per_coord
        block = rows[start - spec.local_start:][:per_coord]
        parts.append(block.to(resolve_device(device), copy=True))
        starts.append(start)
    return Sharded(tuple(parts), tuple(starts), spec.global_batch, 0)
