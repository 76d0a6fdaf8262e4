"""Per-task communicator construction (mirror of
``repro.core.communicator``).

In Deep RC (paper), the RemoteAgent builds an MPI/GLOO/NCCL communicator
with N ranks for each task *at runtime, in constant time* — the measured
3–8 s overhead of Table 2.  The port carves the port's 1-D
``launch.mesh.Mesh`` over the leased device: host-side metadata, built in
constant time.  A communicator across several distinct cards needs
collectives between processes, which come with ``core/exec/`` and a
``torch.distributed`` process group (ROADMAP.md queue 1, item 6); asking
for one raises.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.launch.mesh import Mesh


def device_id(device) -> int:
    """The inventory id of a device: ``torch.device.index`` (0 for the
    CPU), or the ``id`` attribute of a stand-in device."""
    if isinstance(device, torch.device):
        return device.index or 0
    return device.id


@dataclasses.dataclass
class Communicator:
    """What a task receives: its mesh plus metadata (cf. an MPI comm)."""

    mesh: Mesh
    backend: str  # "nccl" on CUDA devices; "host" on the CPU
    build_time_s: float
    devices: Tuple
    # which pilot's pool this mesh was carved from (None for meshes built
    # outside the pilot runtime).  Task fns and the migration tests use it
    # to observe *where* an attempt actually ran.
    pilot_uid: Optional[str] = None

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
                "size": self.size,
                "device_ids": [device_id(d) for d in self.devices]}


def build_communicator(
    devices: Sequence,
    mesh_shape: Optional[Tuple[int, ...]] = None,
    mesh_axes: Tuple[str, ...] = ("data",),
    pilot_uid: Optional[str] = None,
) -> Communicator:
    t0 = time.time()
    n = len(devices)
    if mesh_shape is None:
        mesh_shape = (n,)
    want = 1
    for s in mesh_shape:
        want *= s
    if want != n:
        raise ValueError(f"mesh shape {mesh_shape} needs {want} devices, got {n}")
    if len(set(devices)) != 1:
        raise NotImplementedError(
            f"a communicator over {n} devices needs collectives between "
            "processes: they come with core/exec/ and a torch.distributed "
            "process group (ROADMAP.md queue 1, item 6)")
    dev = torch.device(devices[0])
    mesh = Mesh(dict(zip(mesh_axes, mesh_shape)), dev)
    backend = "nccl" if dev.type == "cuda" else "host"
    return Communicator(mesh, backend, time.time() - t0, tuple(devices),
                        pilot_uid=pilot_uid)
