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

The JAX package's cross-process transports (``"subprocess"``, a pool of
worker processes, and ``"jax-distributed"``, its multi-host flavour) come
with the port's ``core/exec/`` (ROADMAP.md queue 1, item 6); asking for
them raises ``NotImplementedError``.
"""
from __future__ import annotations

import abc
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Optional

_REMOTE = ("subprocess", "jax-distributed")


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


def make_transport(spec: str) -> Optional[Transport]:
    """Resolve a transport spec string: ``"in-process"`` is the agent's
    own default pool (None); the cross-process specs raise."""
    if spec == "in-process":
        return None
    if spec in _REMOTE:
        raise NotImplementedError(
            f"transport {spec!r}: the cross-process transports come with the "
            "port's core/exec/ (ROADMAP.md queue 1, item 6); the port runs "
            "tasks in-process")
    raise ValueError(
        f"unknown transport spec {spec!r}: expected 'in-process', "
        "'subprocess', 'jax-distributed', or a Transport instance")
