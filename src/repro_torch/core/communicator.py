"""Per-task communicator construction (mirror of
``repro.core.communicator``).

In Deep RC (paper), the RemoteAgent builds an MPI/GLOO/NCCL communicator
with N ranks for each task *at runtime, in constant time* — the measured
3–8 s overhead of Table 2.  The port has two kinds:

- in one process, :func:`build_communicator` carves a logical
  ``launch.mesh.Mesh`` over the leased device: host-side metadata, built
  in constant time.  One process cannot hold several cards, so a lease of
  distinct cards raises there and names the remedy,
  ``transport="subprocess"``;
- across cards, one task is *ganged* over N worker processes of a
  ``SubprocessTransport`` (``core/exec/``), one leased device each: every
  rank joins a ``torch.distributed`` group (NCCL when the ranks' cards
  are distinct, gloo when two ranks share a card or run on the CPU) and
  calls :func:`build_gang_communicator`, whose mesh is a
  ``launch.mesh.ProcessMesh`` over the ranks.

The gang's result contract: every rank runs the task fn, and the
attempt's result is rank 0's.  The fn decides what rank 0 returns, for
example host values taken after its collectives.  JAX's single
controller sees every shard of its mesh, so a task that returns host
values computed from the whole mesh returns the same thing in both
packages.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence, Tuple, Union

import torch

from repro_torch.launch.mesh import Mesh, ProcessMesh, make_process_mesh


def device_id(device) -> int:
    """The inventory id of a device: ``torch.device.index`` (0 for the
    CPU), or the ``id`` attribute of a stand-in device."""
    if isinstance(device, torch.device):
        return device.index or 0
    return device.id


def device_type(device) -> str:
    """The device type of a leased device: ``torch.device.type``, or
    ``"cpu"`` for a stand-in device (the tests' pools)."""
    if isinstance(device, torch.device):
        return device.type
    return "cpu"


@dataclasses.dataclass
class Communicator:
    """What a task receives: its mesh plus metadata (cf. an MPI comm)."""

    mesh: Union[Mesh, ProcessMesh]
    # in one process "nccl" on CUDA devices and "host" on the CPU; in a
    # gang, its process group's backend, "nccl" or "gloo"
    backend: str
    build_time_s: float
    devices: Tuple  # in a gang, every rank's leased device in rank order
    # which pilot's pool this mesh was carved from (None for meshes built
    # outside the pilot runtime).  Task fns and the migration tests use it
    # to observe *where* an attempt actually ran.
    pilot_uid: Optional[str] = None
    #: this process's rank in its gang; None outside a gang
    rank: Optional[int] = None

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """The device the task's tensors live on."""
        return self.mesh.device

    def axis_size(self, name: str) -> int:
        return self.mesh.shape[name]

    def describe(self) -> dict:
        return {"pilot": self.pilot_uid, "backend": self.backend,
                "size": self.size, "rank": self.rank,
                "device_ids": [device_id(d) for d in self.devices]}


def _check_shape(n: int, mesh_shape) -> Tuple[int, ...]:
    if mesh_shape is None:
        return (n,)
    want = 1
    for s in mesh_shape:
        want *= s
    if want != n:
        raise ValueError(f"mesh shape {mesh_shape} needs {want} devices, got {n}")
    return tuple(mesh_shape)


def build_communicator(
    devices: Sequence,
    mesh_shape: Optional[Tuple[int, ...]] = None,
    mesh_axes: Tuple[str, ...] = ("data",),
    pilot_uid: Optional[str] = None,
) -> Communicator:
    t0 = time.time()
    n = len(devices)
    mesh_shape = _check_shape(n, mesh_shape)
    if len(set(devices)) != 1:
        raise ValueError(
            f"a communicator over {n} distinct devices cannot live in one "
            "process: run the task on a worker pool (transport=\"subprocess\"),"
            f" which gangs it over {n} worker processes, one device each")
    dev = torch.device(devices[0])
    mesh = Mesh(dict(zip(mesh_axes, mesh_shape)), dev)
    backend = "nccl" if dev.type == "cuda" else "host"
    return Communicator(mesh, backend, time.time() - t0, tuple(devices),
                        pilot_uid=pilot_uid)


def build_gang_communicator(
    devices: Sequence,
    mesh_shape: Optional[Tuple[int, ...]] = None,
    mesh_axes: Tuple[str, ...] = ("data",),
    device=None,
    pilot_uid: Optional[str] = None,
) -> Communicator:
    """This rank's communicator of a gang: a ``ProcessMesh`` over the ranks
    of the initialized default process group, one rank per leased device.
    Every rank calls it with the same arguments but its own ``device``
    (the card unless the caller asks for the CPU)."""
    import torch.distributed as dist

    t0 = time.time()
    n = len(devices)
    mesh_shape = _check_shape(n, mesh_shape)
    if not dist.is_initialized() or dist.get_world_size() != n:
        raise RuntimeError(
            f"a gang over {n} devices needs a process group of {n} ranks "
            f"(initialized: {dist.is_initialized()})")
    mesh = make_process_mesh(mesh_shape, mesh_axes, device=device)
    return Communicator(mesh, mesh.backend, time.time() - t0, tuple(devices),
                        pilot_uid=pilot_uid, rank=mesh.rank)
