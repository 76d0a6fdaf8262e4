"""Task model: the RADICAL-Pilot ``TaskDescription`` analogue (mirror of
``repro.core.task``).

A task is a Python callable plus a resource request (device count / mesh
shape).  The RemoteAgent carves a Communicator (mesh slice) matching the
request and calls ``fn(comm, *args)``.  Tasks carry retry/straggler policy
— the paper's fault-isolation claim (§2.3) is enforced at this boundary:
a task failure never propagates outside its Task record.
"""
from __future__ import annotations

import collections
import dataclasses
import enum
import threading
import time
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple


class TaskState(enum.Enum):
    PENDING = "pending"
    RUNNING = "running"
    DONE = "done"
    FAILED = "failed"
    CANCELED = "canceled"
    # a service task that yielded its devices to higher-priority work; the
    # agent re-queues it (with its checkpointed state) — transient, like a
    # FAILED task awaiting retry, and never consumes retry budget
    PREEMPTED = "preempted"


class ServicePreempted(Exception):
    """Raised by a service task body to yield its devices.

    ``state`` is the service's checkpoint (whatever its ``resume_state``
    contract accepts); the agent stashes it on the TaskDescription and
    re-invokes the task with ``resume_state=state`` once devices free up.
    Preemption is cooperative: the agent requests it through the task's
    :class:`ServiceControl`, and the service raises between work units.
    """

    def __init__(self, state: Any = None):
        super().__init__("service preempted")
        self.state = state


class ServiceControl:
    """Control handle for a ``service=True`` task (a long-running stage).

    The submitting side holds this object and uses ``submit_request`` /
    ``drain`` / ``stop``; the service body polls ``take_requests`` /
    ``preempt_requested`` / ``stop_requested`` between work units.  The
    handle lives on the TaskDescription, so it survives preemption and
    retries — requests queued while the service is yielded are delivered
    when it resumes.
    """

    def __init__(self):
        self._cond = threading.Condition()
        self._inbox: Deque[Any] = collections.deque()  # guarded-by: _cond
        self._stop = False  # guarded-by: _cond
        self._drain = False  # guarded-by: _cond
        self._preempt = False  # guarded-by: _cond
        self.accepted = 0  # guarded-by: _cond

    # -- submitting side -----------------------------------------------------

    def submit_request(self, request: Any) -> Any:
        """Queue a request for the service; returns the request."""
        with self._cond:
            if self._stop or self._drain:
                raise RuntimeError(
                    "service is stopping/draining; not accepting requests")
            self._inbox.append(request)
            self.accepted += 1
            self._cond.notify_all()
        return request

    def drain(self) -> None:
        """Stop admitting new requests; the service exits once every
        accepted request has finished."""
        with self._cond:
            self._drain = True
            self._cond.notify_all()

    def stop(self) -> None:
        """Ask the service to exit as soon as possible (accepted requests
        may be abandoned; use ``drain`` first for a graceful stop)."""
        with self._cond:
            self._stop = True
            self._cond.notify_all()

    # -- agent side ----------------------------------------------------------

    def request_preempt(self) -> None:
        with self._cond:
            self._preempt = True
            self._cond.notify_all()

    def _clear_preempt(self) -> None:
        with self._cond:
            self._preempt = False

    # -- service body --------------------------------------------------------

    def take_requests(self, max_n: Optional[int] = None) -> List[Any]:
        """Pop up to ``max_n`` queued requests (all of them by default)."""
        with self._cond:
            n = len(self._inbox) if max_n is None else min(max_n, len(self._inbox))
            return [self._inbox.popleft() for _ in range(n)]

    def pending_requests(self) -> int:
        with self._cond:
            return len(self._inbox)

    def stop_requested(self) -> bool:
        with self._cond:
            return self._stop

    def drain_requested(self) -> bool:
        with self._cond:
            return self._drain

    def preempt_requested(self) -> bool:
        with self._cond:
            return self._preempt

    def wait_for_work(self, timeout: Optional[float] = None) -> bool:
        """Idle-wait until a request arrives or a control flag flips."""
        with self._cond:
            if self._inbox or self._stop or self._drain or self._preempt:
                return True
            return self._cond.wait(timeout)


@dataclasses.dataclass
class TaskDescription:
    """What the user submits (cf. radical.pilot.TaskDescription)."""

    name: str
    fn: Callable  # fn(comm, *args) -> result
    args: Tuple = ()
    kind: str = "generic"  # data_engineering | train | inference | generic
    # resource request
    num_devices: int = 1
    mesh_axes: Tuple[str, ...] = ("data",)
    mesh_shape: Optional[Tuple[int, ...]] = None  # default: (num_devices,)
    # policy.  ``max_retries`` is the legacy knob; setting ``policy`` (a
    # FailurePolicy: ``deadline_at``, ``allow_retry``, ``backoff_s``,
    # ``attempt_timeout_s``, ``deadline_s``) supersedes it and adds
    # exponential backoff between attempts and an end-to-end deadline
    # across all attempts (``repro_torch.core.resilience``).
    max_retries: int = 2
    policy: Any = None
    priority: int = 0
    timeout_s: Optional[float] = None
    speculative: bool = True  # eligible for straggler duplicate execution
    tags: Dict[str, str] = dataclasses.field(default_factory=dict)
    # scheduling group (typically the owning pipeline's name).  Grouped
    # tasks share the agent's per-group device quota and appear in its
    # lease trace; ungrouped tasks are unconstrained.
    group: Optional[str] = None
    # checkpoint-aware retry: when set, the agent calls
    # ``fn(comm, *args, resume_step=<last completed step>)`` — None on the
    # first attempt, and the latest step found under ``checkpoint_dir`` on
    # every retry, so the task fn resumes instead of rediscovering it.
    checkpoint_dir: Optional[str] = None
    resume_step: Optional[int] = None  # written by the agent, not the user
    # service mode: a long-running stage (e.g. a continuous-batching
    # inference engine) that holds its lease until told to stop.  The
    # agent calls ``fn(comm, *args, control=<ServiceControl>,
    # resume_state=None)``; the fn may raise :class:`ServicePreempted`
    # (carrying its checkpoint) when ``control.preempt_requested()`` —
    # the agent releases the lease and re-queues the task, and the next
    # attempt receives ``resume_state=<checkpoint>``.  Preemption never
    # consumes retry budget.
    service: bool = False
    control: Optional[ServiceControl] = None
    resume_state: Any = None  # written by the agent, not the user

    def __post_init__(self):
        if self.service:
            if self.control is None:
                self.control = ServiceControl()
            # a duplicate engine racing the primary would double-serve
            # requests — service tasks are never speculated
            self.speculative = False


@dataclasses.dataclass
class Task:
    uid: str
    description: TaskDescription
    state: TaskState = TaskState.PENDING
    result: Any = None
    error: Optional[str] = None
    attempts: int = 0
    preemptions: int = 0  # times a service attempt yielded to higher priority
    # failure-policy scheduling state (written by the agent): a retry
    # backoff parks the task until ``not_before``; ``deadline`` is the
    # absolute end-to-end cutoff derived from ``policy.deadline_s``
    not_before: float = 0.0
    deadline: Optional[float] = None
    submitted_at: float = dataclasses.field(default_factory=time.time)
    started_at: Optional[float] = None
    finished_at: Optional[float] = None
    # overhead decomposition (the paper's Table 2 metric)
    overhead_s: Dict[str, float] = dataclasses.field(default_factory=dict)
    # -- async completion machinery (set by the agent) ----------------------
    # ``finalized`` flips exactly once, when the agent decides no further
    # attempts will run (success, exhausted retries, or cancellation); only
    # then do callbacks fire and ``wait`` return.  A FAILED state alone is
    # not terminal — the task may still be retried.
    finalized: bool = dataclasses.field(default=False, repr=False, compare=False)
    _finished: threading.Event = dataclasses.field(
        default_factory=threading.Event, repr=False, compare=False)
    _callbacks: List[Callable[["Task"], None]] = dataclasses.field(  # guarded-by: _cb_lock
        default_factory=list, repr=False, compare=False)
    _cb_lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False)

    @property
    def duration_s(self) -> Optional[float]:
        if self.started_at is None or self.finished_at is None:
            return None
        return self.finished_at - self.started_at

    def done(self) -> bool:
        return self.state in (TaskState.DONE, TaskState.FAILED, TaskState.CANCELED)

    def add_done_callback(self, cb: Callable[["Task"], None]) -> None:
        """Register ``cb(task)`` to run when the task reaches a terminal
        state (after all retries).  Fires immediately if already terminal.
        The lock closes the check-then-append race against the agent
        draining callbacks at finalization."""
        with self._cb_lock:
            if not self._finished.is_set():
                self._callbacks.append(cb)
                return
        cb(self)

    def _drain_callbacks(self) -> List[Callable[["Task"], None]]:
        """Agent-side: atomically mark finished and take the callbacks."""
        with self._cb_lock:
            self._finished.set()
            callbacks, self._callbacks = self._callbacks, []
        return callbacks

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the task is terminal; True if it finished in time."""
        return self._finished.wait(timeout)


class DeviceFailure(RuntimeError):
    """Simulated node/device loss (tests + chaos benchmarks inject this)."""

    def __init__(self, device_ids, msg="device failure"):
        super().__init__(msg)
        self.device_ids = tuple(device_ids)
