"""Meshes of the port (mirror of ``repro.launch.mesh``).

JAX runs the dataframe operators single-controller: one process sees every
shard of a ``Mesh`` and ``shard_map`` runs the body on each.  The port
mirrors that on one device: a 1-D mesh of ``n`` logical shards, whose
tables keep shard ``i`` in rows ``[i*per, (i+1)*per)`` of each column, and
whose collectives are tensor operations on that layout
(``repro_torch.dataframe.ops_dist``).  JAX's production and multi-pod
meshes, and meshes over several processes, come with the runtime slice
(ROADMAP.md queue 1, item 11).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import torch


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
    """``shape[axis]`` logical shards, all on ``device``."""
    shape: Dict[str, int]
    device: torch.device


def make_mesh(shape: Sequence[int], axes: Sequence[str], device=None) -> Mesh:
    """A 1-D mesh of ``shape[0]`` shards on ``device`` (the card unless
    the caller asks for the CPU)."""
    if len(shape) != 1 or len(axes) != 1:
        raise NotImplementedError(
            "the port's meshes are 1-D; multi-axis meshes come with the "
            "runtime slice (ROADMAP.md queue 1, item 11)")
    if shape[0] < 1:
        raise ValueError(f"a mesh needs at least one shard, got {shape[0]}")
    return Mesh({axes[0]: int(shape[0])}, resolve_device(device))
