"""Cylon-analogue columnar Table (mirror of ``repro.dataframe.table``).

A :class:`Table` is a dict of equal-length column tensors plus a bool
``valid`` row mask, on one device.  With a mesh of ``n`` logical shards
(``repro_torch.launch.mesh``), shard ``i`` owns rows ``[i*per,
(i+1)*per)`` of every column, as in JAX's layout.  On a process mesh
(``ProcessMesh``) a Table holds only this rank's shard, on the rank's
device, and every rank's shard has the same number of rows.  Ragged
partitions are ``valid`` masks over the fixed capacity, and the
distributed operators (:mod:`repro_torch.dataframe.ops_dist`) exchange
rows between the shards.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.launch.mesh import Mesh, ProcessMesh, resolve_device


@dataclasses.dataclass
class Table:
    columns: Dict[str, torch.Tensor]
    valid: torch.Tensor  # bool [N]
    mesh: Optional[Union[Mesh, ProcessMesh]] = None
    axis: str = "data"

    # -- construction -------------------------------------------------------

    @staticmethod
    def from_columns(columns: Dict[str, Any], mesh: Optional[Mesh] = None,
                     axis: str = "data", valid=None, device=None) -> "Table":
        """Columns on the mesh's device, or on ``device`` without a mesh
        (the card unless the caller asks for the CPU)."""
        if mesh is not None and device is not None \
                and torch.device(device) != mesh.device:
            raise ValueError(f"device {device} is not the mesh's {mesh.device}")
        dev = mesh.device if mesh is not None else resolve_device(device)
        cols = {k: torch.as_tensor(v, device=dev) for k, v in columns.items()}
        n = next(iter(cols.values())).shape[0]
        for k, v in cols.items():
            if v.shape[0] != n:
                raise ValueError(f"column {k} length {v.shape[0]} != {n}")
        if valid is None:
            valid = torch.ones((n,), dtype=torch.bool, device=dev)
        t = Table(cols, torch.as_tensor(valid, device=dev).to(torch.bool), mesh, axis)
        if mesh is not None:
            t = t.reshard(mesh, axis)
        return t

    def reshard(self, mesh: Mesh, axis: str = "data") -> "Table":
        """Distribute rows over the mesh axis: pad with invalid rows to a
        multiple of the shard count, on the mesh's device.  On a process
        mesh the rows are this rank's shard: moved, never padded."""
        pad = 0 if isinstance(mesh, ProcessMesh) else (-self.num_rows) % mesh.shape[axis]

        def place(c):
            if pad:
                c = torch.cat([c, c.new_zeros((pad,) + tuple(c.shape[1:]))])
            return c.to(mesh.device)

        return Table({k: place(v) for k, v in self.columns.items()},
                     place(self.valid), mesh, axis)

    # -- basics --------------------------------------------------------------

    @property
    def num_rows(self) -> int:
        return int(self.valid.shape[0])

    @property
    def num_valid(self) -> int:
        return int(self.valid.sum())

    @property
    def column_names(self):
        return list(self.columns)

    def col(self, name: str) -> torch.Tensor:
        return self.columns[name]

    def with_columns(self, columns, valid=None) -> "Table":
        return Table(dict(columns), self.valid if valid is None else valid,
                     self.mesh, self.axis)

    def project(self, names: Sequence[str]) -> "Table":
        return self.with_columns({k: self.columns[k] for k in names})

    def to_numpy(self) -> Dict[str, np.ndarray]:
        """Gather valid rows to host (postprocessing / tests)."""
        mask = self.valid.cpu().numpy()
        return {k: v.cpu().numpy()[mask] for k, v in self.columns.items()}

    def head(self, n: int = 5) -> Dict[str, np.ndarray]:
        data = self.to_numpy()
        return {k: v[:n] for k, v in data.items()}
