"""Module-level task adapter shipped to subprocess workers (mirror of
``repro.core.exec.remote``).

The agent's in-process execution path is a bound method
(``RemoteAgent._run_one``) holding the pilot, locks, and scheduling
state — none of which can or should cross a process boundary.  For a
remote transport the agent instead ships :func:`run_task_body`, which
reproduces the *execution* half of ``_run_one`` inside the worker: carve
a communicator over the worker's own device pool, then call the task fn
under the checkpoint/service kwarg contract.  All *scheduling* state
(attempts, leases, quotas, retry decisions) stays with the dispatcher in
the parent process — the single-master contract.

The worker's device pool is of the device type the parent leased: the
cards the worker sees (``CUDA_VISIBLE_DEVICES``, set by the transport)
for ``"cuda"``, ``pool_size`` logical devices of the one CPU for
``"cpu"``.  The leased device count is a *width request* that degrades
to the local pool size, the elastic contract the in-process path applies
on device failure: on a one-card machine a 2-device lease runs at width
1.  A lease of ``"cuda"`` in a worker without a GPU raises; it never
carries on on the CPU.  A ``DeviceFailure`` raised by the task fn inside
a worker is reported as a plain task failure (worker-local device ids do
not map onto the parent pilot's inventory); the real fault-detection
path for remote execution is process death, which the transport turns
into ``WorkerCrashed``.

A task whose lease is wider than one worker can hold (distinct cards, or
more devices than a worker's pool) runs as a *gang* instead: the
transport ships :func:`run_gang_body` to N workers at once, one leased
device each.  Every rank joins a fresh ``torch.distributed`` group,
builds its communicator over a ``ProcessMesh`` and runs the task fn under
the same kwarg contract; the attempt's result is rank 0's
(``core/communicator.py``).  The group is destroyed on the way out, so
the worker serves the next task clean.
"""
from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

#: the worker's logical CPU pool size (the transport's ``worker_devices``)
POOL_ENV = "REPRO_WORKER_DEVICES"


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= x
    return out


def _mesh_of(n: int, mesh_shape, mesh_axes) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """The task's mesh shape and axes at width ``n``, or a 1-D ``data``
    mesh when the leased width does not fill the shape it asked for."""
    shape = tuple(mesh_shape) if mesh_shape and n == _prod(mesh_shape) else (n,)
    axes = tuple(mesh_axes) if len(shape) == len(mesh_axes) else ("data",)
    return shape, axes


def local_pool(device_type: str) -> List:
    """The devices of ``device_type`` this worker owns."""
    import torch

    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the parent leased a CUDA device but this worker sees no GPU "
                f"(CUDA_VISIBLE_DEVICES={os.environ.get('CUDA_VISIBLE_DEVICES')!r})")
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if device_type == "cpu":
        return [torch.device("cpu")] * max(1, int(os.environ.get(POOL_ENV, "1")))
    raise ValueError(f"unknown device type {device_type!r}")


def run_task_body(fn,
                  args: Sequence[Any],
                  kwargs: Mapping[str, Any],
                  num_devices: int,
                  mesh_shape: Optional[Tuple[int, ...]],
                  mesh_axes: Tuple[str, ...],
                  device_type: str,
                  control=None) -> Dict[str, Any]:
    """Run one task attempt inside a worker process.

    Returns ``{"result": <fn's return>, "overhead": {...}}`` so the
    parent-side agent can merge the worker's communicator-build timing
    into the task's overhead decomposition.  ``ServicePreempted`` (and
    any other exception) propagates to the worker daemon, which reports
    it as a typed result message.
    """
    from repro_torch.core.communicator import build_communicator

    t0 = time.time()
    pool = local_pool(device_type)
    n = max(1, min(int(num_devices), len(pool)))
    devices = pool[:n]
    comm = build_communicator(devices, *_mesh_of(n, mesh_shape, mesh_axes))
    overhead = {"communicator": time.time() - t0}
    call_kwargs = dict(kwargs)
    if control is not None:
        # service contract: the worker daemon injects its ServiceControl
        # replica; the task fn drives it exactly like the in-process one
        call_kwargs["control"] = control
    result = fn(comm, *args, **call_kwargs)
    return {"result": result, "overhead": overhead}


def run_gang_body(rendezvous: Mapping[str, Any],
                  fn,
                  args: Sequence[Any],
                  kwargs: Mapping[str, Any],
                  devices: Sequence,
                  mesh_shape: Optional[Tuple[int, ...]],
                  mesh_axes: Tuple[str, ...],
                  pilot_uid: Optional[str] = None) -> Dict[str, Any]:
    """Run one rank of a gang attempt inside a worker process.

    ``rendezvous`` is this rank's part of the gang, from the transport:
    ``rank``, ``world``, ``init_method`` (a fresh ``tcp://127.0.0.1:<port>``
    per attempt), ``backend``, ``device`` (this worker's index of the
    leased card, or ``"cpu"``) and ``timeout_s``, the process group's
    bound on the rendezvous and on every collective.  ``devices`` are
    the whole gang's leased devices, in rank order.  Returns what
    :func:`run_task_body` returns, plus the rank and the seconds the
    rendezvous took.
    """
    import datetime

    import torch
    import torch.distributed as dist

    from repro_torch.core.communicator import build_gang_communicator

    t0 = time.time()
    dev = torch.device(rendezvous["device"])
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the parent leased a CUDA device but this worker sees no GPU "
                f"(CUDA_VISIBLE_DEVICES={os.environ.get('CUDA_VISIBLE_DEVICES')!r})")
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        dist.destroy_process_group()  # never join a gang over a stale group
    dist.init_process_group(
        rendezvous["backend"], init_method=rendezvous["init_method"],
        world_size=int(rendezvous["world"]), rank=int(rendezvous["rank"]),
        timeout=datetime.timedelta(seconds=float(rendezvous["timeout_s"])))
    try:
        joined = time.time()
        comm = build_gang_communicator(
            devices, *_mesh_of(len(devices), mesh_shape, mesh_axes), device=dev,
            pilot_uid=pilot_uid)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)  # the mesh may pick rank % count
        overhead = {"rendezvous": joined - t0, "communicator": time.time() - t0}
        result = fn(comm, *args, **dict(kwargs))
        return {"result": result, "overhead": overhead, "rank": comm.rank}
    finally:
        dist.destroy_process_group()
