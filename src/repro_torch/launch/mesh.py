"""Meshes of the port (mirror of ``repro.launch.mesh``).

Two kinds.  A :class:`Mesh` holds logical shards on one device: JAX runs
the dataframe operators single-controller (one process sees every shard of
a ``Mesh`` and ``shard_map`` runs the body on each), and the port mirrors
that with tables that keep shard ``i`` of an axis in rows ``[i*per,
(i+1)*per)`` and collectives that are tensor operations on that layout
(``repro_torch.dataframe.ops_dist``).  It may have several named axes, as
JAX's production meshes do; an operator works over the one axis it names.

A :class:`ProcessMesh` holds one shard per process of an initialized
``torch.distributed`` default group: named axes over the ranks (row-major,
as ``init_device_mesh`` lays them out), this rank's coordinates and one
subgroup per axis.  Its collectives are ``torch.distributed``'s on those
subgroups, on the backend the group was initialized with.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Sequence

import torch

# gloo's collectives take CUDA tensors, but its point-to-point send of one
# aborts the process (gloo::IoException "writev: Bad address", torch 2.11,
# H100): those ops go through host copies on gloo
GLOO = "gloo"


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Without a GPU that raises: only an
    explicit ``"cpu"`` runs on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU by default; pass "
            "device='cpu' to run on the CPU")
    return dev


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``shape[axis]`` logical shards along each axis, all on ``device``."""
    shape: Dict[str, int]
    device: torch.device


def make_mesh(shape: Sequence[int], axes: Sequence[str], device=None) -> Mesh:
    """A mesh of logical shards on ``device`` (the card unless the caller
    asks for the CPU), ``shape[i]`` along axis ``axes[i]``."""
    if len(shape) != len(axes) or len(set(axes)) != len(axes):
        raise ValueError(f"a mesh needs one distinct name per dim: {shape}, {axes}")
    if min(shape, default=0) < 1:
        raise ValueError(f"a mesh needs at least one shard per axis, got {shape}")
    return Mesh({a: int(s) for a, s in zip(axes, shape)}, resolve_device(device))


@dataclasses.dataclass(frozen=True, eq=False)
class ProcessMesh:
    """One shard per rank of the default process group, laid out row-major
    over ``shape``; this rank's tensors live on ``device``."""
    shape: Dict[str, int]
    device: torch.device
    backend: str
    rank: int
    coords: Dict[str, int]
    device_mesh: Any  # torch.distributed.device_mesh.DeviceMesh

    def group(self, axis: str):
        """The process group of this rank's line along ``axis``."""
        return self.device_mesh.get_group(axis)

    @property
    def p2p_device(self) -> torch.device:
        """Where point-to-point messages are staged: the host on gloo, the
        tensors' own device otherwise."""
        return torch.device("cpu") if self.backend == GLOO else self.device


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The dry run's logical mesh on the meta device.  Single pod: (16,
    16) = (data, model), a stand-in for 256 H100s, 8 a node; multi-pod:
    (2, 16, 16) = (pod, data, model), 512 of them.  No such cluster was
    ever run: only the sharding rules read the mesh (``spec_for`` reads
    ``mesh.shape``), so no device stands behind a shard."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device="meta")


def make_process_mesh(shape: Sequence[int], axes: Sequence[str],
                      device=None) -> ProcessMesh:
    """A mesh over the ranks of the initialized default group, whose size
    must be the product of ``shape``.  Every rank calls it, with the same
    arguments (the subgroups are created collectively).  ``device`` is this
    rank's device: the card unless the caller asks for the CPU."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("a process mesh needs torch.distributed's default "
                           "group: call init_process_group first")
    if len(shape) != len(axes) or len(set(axes)) != len(axes):
        raise ValueError(f"a mesh needs one distinct name per dim: {shape}, {axes}")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh {tuple(shape)} has {math.prod(shape)} shards, "
                         f"the group {world} ranks")
    dev = resolve_device(device)
    dm = init_device_mesh(dev.type, tuple(int(s) for s in shape),
                          mesh_dim_names=tuple(axes))
    rank = dist.get_rank()
    coords = dict(zip(axes, dm.get_coordinate()))
    return ProcessMesh({a: int(s) for a, s in zip(axes, shape)}, dev,
                       dist.get_backend(), rank, coords, dm)
