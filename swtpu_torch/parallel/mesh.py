"""The device mesh of the port: an ordered list of this process's devices
along one axis.

The port of ``swtpu.parallel.mesh``.  The scaling axis of the workload is
the database (reads): queries are replicated, reads are sharded, and
score and top-K merges gather across the shards (``parallel.sharded``)
and, when a ``torch.distributed`` process group is up, across processes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh over the database axis.

    devices: this process's devices in shard order; a device may repeat
      (``[torch.device("cpu")] * 8``, ``[torch.device("cuda:0")] * 4``):
      each entry is one shard, which is the counterpart of swtpu's virtual
      CPU devices (``--xla_force_host_platform_device_count``) and lets a
      machine with one card run a mesh of several shards.
    axis_name: the axis' name, which the sharded functions check.
    rank / world_size: this process's place in the ``torch.distributed``
      group (0 / 1 without one, like ``jax.process_index()`` and
      ``jax.process_count()``); collectives cross processes when
      world_size > 1.
    """

    devices: Tuple[torch.device, ...]
    axis_name: str = "data"
    rank: int = 0
    world_size: int = 1

    @property
    def shape(self) -> dict:
        """{axis_name: shards of this process}."""
        return {self.axis_name: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(
    n_devices: Optional[int] = None,
    axis_name: str = "data",
    devices: Optional[Sequence] = None,
) -> Mesh:
    """1-D mesh over the database axis: every visible CUDA device by
    default (the first `n_devices` of them), or `devices` (anything
    ``torch.device`` takes; CPU devices, repeats) in that order.  Raises
    when no CUDA device is visible and `devices` is not given: there is no
    CPU default."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device is visible; pass devices= to "
                "build a mesh on others (e.g. [torch.device('cpu')] * 8)"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("make_mesh: the mesh has no device")
    if any(d.type == "cuda" for d in devices) and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: a CUDA device was named but none is available")
    rank, world = 0, 1
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        rank, world = torch.distributed.get_rank(), torch.distributed.get_world_size()
    return Mesh(tuple(devices), axis_name, rank, world)
