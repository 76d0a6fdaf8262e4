"""The Deep RC Bridge (paper Fig. 2): Data Bridge + System Bridge
(mirror of ``repro.core.bridge``).

* ``data_bridge`` — Cylon GT -> zero-copy loader for the DL framework
  (repro_torch.bridge.loader).  The GT's device buffers ARE the training input.
* ``system_bridge`` — wraps a dataframe operation as a pilot task whose
  output feeds downstream train/infer tasks (resource flow Cylon -> RP).

``cylon_stage`` / ``dl_stage`` build raw :class:`Stage` objects for the
positional ``fn(comm, upstream, *args)`` contract; new code should
prefer the ``@stage`` decorator DSL in :mod:`repro_torch.core.session`, whose
kinds (``data_engineering`` / ``train`` / ``inference``) drive the
Session's per-stage pod placement the same way.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

from repro_torch.bridge.loader import ZeroCopyLoader
from repro_torch.core.pipeline import Stage
from repro_torch.dataframe.table import Table


def data_bridge(
    table: Table,
    feature_cols: Sequence[str],
    label_col: str,
    global_batch: int,
    **kw,
) -> ZeroCopyLoader:
    return ZeroCopyLoader(table, feature_cols, label_col, global_batch, **kw)


def cylon_stage(
    name: str,
    df_fn: Callable,  # df_fn(comm, upstream) -> Table
    *,
    num_devices: int = 1,
    deps: Sequence[str] = (),
) -> Stage:
    """System Bridge: a data-engineering stage running on CPUs (a 1-D
    worker mesh), producing a GT consumed by DL stages."""
    return Stage(name=name, fn=df_fn, kind="data_engineering",
                 num_devices=num_devices, mesh_axes=("data",), deps=deps)


def dl_stage(
    name: str,
    train_fn: Callable,  # train_fn(comm, upstream[, resume_step=...]) -> result
    *,
    num_devices: int = 1,
    mesh_shape: Optional[tuple] = None,
    mesh_axes: tuple = ("data",),
    deps: Sequence[str] = (),
    kind: str = "train",
    checkpoint_dir: Optional[str] = None,
) -> Stage:
    """``checkpoint_dir`` opts the stage into checkpoint-aware retry: the
    agent passes ``resume_step`` (last completed step under that dir) to
    ``train_fn`` on every retried attempt — see RemoteAgent docs."""
    return Stage(name=name, fn=train_fn, kind=kind, num_devices=num_devices,
                 mesh_axes=mesh_axes, mesh_shape=mesh_shape, deps=deps,
                 checkpoint_dir=checkpoint_dir)
