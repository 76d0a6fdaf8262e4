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
    shape = (tuple(mesh_shape)
             if mesh_shape and len(devices) == _prod(mesh_shape)
             else (len(devices),))
    axes = (tuple(mesh_axes) if len(shape) == len(mesh_axes) else ("data",))
    comm = build_communicator(devices, shape, axes)
    overhead = {"communicator": time.time() - t0}
    call_kwargs = dict(kwargs)
    if control is not None:
        # service contract: the worker daemon injects its ServiceControl
        # replica; the task fn drives it exactly like the in-process one
        call_kwargs["control"] = control
    result = fn(comm, *args, **call_kwargs)
    return {"result": result, "overhead": overhead}
