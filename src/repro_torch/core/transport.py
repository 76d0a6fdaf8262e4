"""Task transports: where a leased task attempt actually executes (mirror
of ``repro.core.transport``).

The execution stack is layered ``pipeline -> PilotManager -> Pilot ->
Transport``: the PilotManager places pipelines on pilots, the pilot's
RemoteAgent decides *when* a task runs (condition-variable dispatcher,
quotas, retries, speculation), and the Transport decides *where* the
attempt's body runs.  The dispatcher stays the single master: a transport
never schedules, it only executes what the dispatcher hands it and
reports completion through the returned Future.

``InProcessTransport`` is the default (a thread pool in the agent's
process: every worker shares one CUDA context).  ``submit`` takes a
callable and returns a ``concurrent.futures.Future``, and ``capacity``
bounds how many attempts the dispatcher keeps in flight.

The cross-process transports live in ``repro_torch.core.exec``:
``"subprocess"`` (``SubprocessTransport``, a pool of worker processes,
each with its own CUDA context) and ``"jax-distributed"``
(``DistributedTransport``, its multi-host flavour); ``make_transport``
builds them from their spec strings.
"""
from __future__ import annotations

import abc
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Optional

_REMOTE = ("subprocess", "jax-distributed")
#: the spec strings a Session, a PilotDescription or make_transport takes
SPECS = ("in-process",) + _REMOTE


class Transport(abc.ABC):
    """Executes task attempts on behalf of a RemoteAgent dispatcher."""

    name: str = "abstract"
    #: max attempts the transport can run concurrently (None = unbounded);
    #: the agent clamps its in-flight window to this.
    capacity: Optional[int] = None

    @abc.abstractmethod
    def submit(self, fn: Callable, *args) -> Future:
        """Run ``fn(*args)`` somewhere; resolve the Future when it returns.
        Must never raise synchronously for an execution error — errors
        travel through the Future (the agent's isolation boundary is
        inside ``fn`` itself)."""

    @abc.abstractmethod
    def shutdown(self, wait: bool = True) -> None:
        """Stop accepting work and (optionally) drain in-flight attempts."""


class InProcessTransport(Transport):
    """Thread-pool execution inside the agent's process (single-host)."""

    name = "in-process"

    def __init__(self, max_workers: int = 4,
                 thread_name_prefix: str = "rc-worker"):
        self.capacity = max_workers
        self._pool = ThreadPoolExecutor(max_workers=max_workers,
                                        thread_name_prefix=thread_name_prefix)

    def submit(self, fn: Callable, *args) -> Future:
        return self._pool.submit(fn, *args)

    def shutdown(self, wait: bool = True) -> None:
        self._pool.shutdown(wait=wait)


def make_transport(spec: str, **options) -> Optional[Transport]:
    """Resolve a transport spec string: ``"in-process"`` is the agent's
    own default pool (None); ``"subprocess"`` and ``"jax-distributed"``
    build a worker pool from ``options`` (``max_workers``,
    ``worker_devices``, ``device``, ...), which the caller owns and shuts
    down."""
    check_spec(spec)
    if spec == "in-process":
        return None
    from repro_torch.core.exec import DistributedTransport, SubprocessTransport
    cls = SubprocessTransport if spec == "subprocess" else DistributedTransport
    return cls(**options)


def check_spec(spec) -> None:
    """Raise ValueError for a spec string that names no transport."""
    if isinstance(spec, str) and spec not in SPECS:
        raise ValueError(
            f"unknown transport spec {spec!r}: expected 'in-process', "
            "'subprocess', 'jax-distributed', or a Transport instance")
