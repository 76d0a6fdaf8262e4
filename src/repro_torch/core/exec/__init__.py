"""Cross-process task execution: subprocess-per-worker transport (mirror
of ``repro.core.exec``).

This package is the process boundary of the runtime.  The layering
contract from ``repro_torch.core.transport`` is unchanged — the
RemoteAgent dispatcher is the single master; a transport only *executes*
— but here the execution happens in a pool of long-lived worker daemon
processes (`repro_torch.core.exec.worker`), each with its own torch
runtime and, on the card, its own CUDA context, speaking a
length-prefixed pickle RPC over localhost sockets
(`repro_torch.core.exec.protocol`) with heartbeat-based liveness
(`repro_torch.core.exec.transport`).

Public surface:

- ``SubprocessTransport`` — the pool.  ``submit(fn, *args, **kwargs)``
  pickles the call, ships it to an idle worker, and returns a Future
  that resolves with the worker's result, raises a reconstructed
  ``RemoteTaskError`` on a remote exception, or raises
  ``WorkerCrashed`` when the worker process dies mid-task (detected by
  process exit or missed heartbeats — never a hang).
- ``DistributedTransport`` — thin subclass (spec ``"jax-distributed"``)
  carrying multi-host coordinates through to the workers'
  ``torch.distributed.init_process_group`` hook; raises a specific
  "no multi-host fabric in this build" error when real multi-host init
  is requested.
- ``WorkerCrashed`` / ``RemoteTaskError`` — the two failure shapes.
- ``ensure_picklable`` — submit-time contract check producing a clear
  ``TypeError`` naming the offending closure/capture, instead of a
  worker-side pickle traceback.
- ``run_task_body`` — the module-level adapter the agent ships instead
  of its (unpicklable) bound ``_run_one``: carves a local communicator
  inside the worker and runs the task fn under it.
- ``run_gang_body`` — one rank of a gang (``SubprocessTransport.submit_gang``):
  joins a fresh process group and runs the task fn on a communicator
  over a ``ProcessMesh`` of the gang's ranks.
"""
from repro_torch.core.exec.pickling import ensure_picklable
from repro_torch.core.exec.remote import run_gang_body, run_task_body
from repro_torch.core.exec.transport import (DistributedTransport,
                                             RemoteTaskError,
                                             SubprocessTransport,
                                             WorkerCrashed)

__all__ = [
    "SubprocessTransport",
    "DistributedTransport",
    "WorkerCrashed",
    "RemoteTaskError",
    "ensure_picklable",
    "run_task_body",
    "run_gang_body",
]
