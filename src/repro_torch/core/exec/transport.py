"""SubprocessTransport: the worker-pool side of cross-process execution
(mirror of ``repro.core.exec.transport``).

Layering contract (unchanged from ``repro_torch.core.transport``): the
RemoteAgent dispatcher is the single master — it decides *when* an
attempt runs; this transport only executes.  Each worker is a long-lived
``repro_torch.core.exec.worker`` daemon process with its own torch
runtime (and, for ``device="cuda"``, its own CUDA context on its share
of the machine's cards, ``CUDA_VISIBLE_DEVICES``), connected back over a
localhost socket speaking the length-prefixed pickle protocol.  Workers
start with ``subprocess.Popen``, never ``fork``: the parent holds a CUDA
context and threads.  One task runs per worker at a time, so
``capacity == max_workers`` and the agent's in-flight window maps 1:1
onto processes.

Fault model — a Future returned by ``submit`` always resolves:

- worker returns → result / reconstructed ``RemoteTaskError`` /
  ``ServicePreempted`` (typed result frames; exception *objects* never
  cross the wire);
- worker process exits (crash, SIGKILL, OOM) → the monitor's
  ``proc.poll`` notices within one poll interval and fails the Future
  with ``WorkerCrashed`` — no heartbeat-timeout wait on the fast path;
- worker hangs without dying → missed heartbeats trip the
  ``heartbeat_timeout_s`` backstop, same ``WorkerCrashed``.

Crashed workers are respawned so the agent's checkpoint-aware retry
finds a live pool — under the transport's :class:`FailurePolicy`:
consecutive crashes of the same worker slot back off exponentially
(deterministic jitter), so a crash-looping worker no longer burns the
lifetime ``max_respawns`` cap in seconds, and every respawn (attempt,
streak, delay) is visible in ``stats()``.  The policy's
``attempt_timeout_s`` (or a per-submit override) is enforced by the
monitor: a busy worker whose attempt outlives its deadline is treated
as hung — which is also what rescues a dropped RPC reply.  ``shutdown``
reaps every worker process either way: ``wait=True`` drains in-flight
work first; ``wait=False`` terminates immediately and fails
outstanding Futures.

Chaos hooks: when a :mod:`repro_torch.core.resilience.faults` injector is
armed, the dispatch path consults the ``transport.dispatch`` site after
handing a worker its task (actions ``crash_worker`` / ``stall_heartbeat``
become ``die`` / ``stall`` frames the worker honours), and each worker
channel consults ``protocol.recv`` per inbound frame (``drop`` /
``delay`` of result replies) — every fault mode above is reproducible
from a seed, with detection and recovery exercising the real paths.

Service tasks: ``submit(..., service_control=ctrl)`` bridges the
caller-held :class:`~repro_torch.core.task.ServiceControl` to a replica
in the worker — queued requests and stop/drain/preempt flags flow down;
token streams and terminal request states flow back and are applied to
the client-held Request objects, so streaming semantics match the
in-process transport.  A token frame that arrives after its request's
``finish`` frame is still applied (``_StreamTable``).

Gangs: ``submit_gang(fn, devices, ...)`` runs one attempt on
``len(devices)`` workers at once, one leased device each, as the ranks of
one ``torch.distributed`` group (``remote.run_gang_body``).  The workers
are checked out all or nothing under the pool's lock, so two gangs never
each hold half the pool.  A rank runs on a worker that sees its leased
card (cards are dealt to worker slots at spawn; the gang picks slots
that hold its cards), and its task frame carries its rendezvous: rank,
world size, a fresh ``tcp://127.0.0.1:<port>``, backend (NCCL for
distinct cards, gloo for a shared card or the CPU) and device.  The one
Future completes with rank 0's result once every rank has returned; the
first rank that raises or dies fails it, and the workers of the ranks
still running are killed at once (they may be blocked in a collective)
and respawned under the respawn backoff.  A gang at the queue head that
the pool's live slots (and those due for respawn) can no longer place,
once the respawn cap is spent, fails at once instead of blocking the
tasks queued behind it.
"""
from __future__ import annotations

import collections
import itertools
import os
import subprocess
import sys
import threading
import time
from concurrent.futures import Future
from types import SimpleNamespace
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence, Union

from repro_torch.core.exec import pickling, protocol
from repro_torch.core.exec.remote import POOL_ENV
from repro_torch.core.resilience import faults as rfaults
from repro_torch.core.resilience.policy import FailurePolicy
from repro_torch.core.task import ServicePreempted
from repro_torch.core.transport import Transport

#: a gang's process-group bound on its rendezvous and collectives when
#: its attempt has no deadline (otherwise the bound is the deadline)
GROUP_TIMEOUT_S = 300.0


class WorkerCrashed(RuntimeError):
    """The worker process executing a task died (or stopped heartbeating)
    before returning a result."""

    def __init__(self, worker_id: int, pid: Optional[int], label: str,
                 reason: str):
        self.worker_id = worker_id
        self.pid = pid
        super().__init__(
            f"worker {worker_id} (pid {pid}) died while running "
            f"{label or 'a task'}: {reason}")


class RemoteTaskError(RuntimeError):
    """A task fn raised inside a worker.  Carries the remote exception's
    type name and traceback text (the object itself never crosses the
    wire — custom exception signatures don't survive pickling)."""

    def __init__(self, etype: str, message: str, traceback_text: str = ""):
        self.remote_type = etype
        self.remote_traceback = traceback_text
        detail = f"\n--- remote traceback ---\n{traceback_text}" \
            if traceback_text else ""
        super().__init__(f"{etype}: {message}{detail}")


class _Job:
    __slots__ = ("jid", "payload", "future", "label", "service_control",
                 "on_done", "worker_id", "attempt_timeout_s", "deadline",
                 "gang", "rank")

    def __init__(self, jid: int, payload: bytes, label: str,
                 service_control, on_done,
                 attempt_timeout_s: Optional[float] = None,
                 gang: Optional["_Gang"] = None, rank: int = 0):
        self.jid = jid
        self.payload = payload
        self.label = label
        self.service_control = service_control
        self.on_done = on_done
        self.future: Future = Future()
        self.worker_id: Optional[int] = None
        self.attempt_timeout_s = attempt_timeout_s
        self.deadline: Optional[float] = None  # set at dispatch
        self.gang = gang  # the gang this rank belongs to, or None
        self.rank = rank


class _Gang:
    """One attempt over several workers: its rank jobs (sharing one
    payload), the physical card of each rank (None on the CPU), and the
    one Future that the caller holds."""

    def __init__(self, on_done, cards: Sequence[Optional[str]], backend: str,
                 timeout_s: float):
        self.on_done = on_done
        self.cards = list(cards)
        self.backend = backend
        self.timeout_s = timeout_s
        self.future: Future = Future()
        self.jobs: List[_Job] = []
        self._lock = threading.Lock()
        self._values: Dict[int, Any] = {}  # guarded-by: _lock
        self._failed = False  # guarded-by: _lock

    def rendezvous(self, rank: int, worker: "_WorkerHandle",
                   port: int) -> Dict[str, Any]:
        """Rank ``rank``'s part of the gang, for the worker it runs on."""
        card = self.cards[rank]
        return {"rank": rank, "world": len(self.cards),
                "init_method": f"tcp://127.0.0.1:{port}",
                "backend": self.backend, "timeout_s": self.timeout_s,
                "device": "cpu" if card is None
                else f"cuda:{worker.cards.index(card)}"}

    def record(self, rank: int, fut: Future) -> Optional[str]:
        """Note one rank's outcome: ``"ok"`` once every rank has returned,
        ``"failed"`` for the first rank that did not, else None."""
        exc = fut.exception(timeout=0)
        with self._lock:
            if self._failed:
                return None
            if exc is not None:
                self._failed = True
                return "failed"
            self._values[rank] = fut.result(timeout=0)
            return "ok" if len(self._values) == len(self.cards) else None

    def value(self) -> Any:
        """Rank 0's result: the attempt's."""
        with self._lock:
            return self._values[0]


def _free_port() -> int:
    """A port on 127.0.0.1 that the OS calls free now (a gang's rendezvous;
    rank 0 binds it)."""
    import socket as _socket
    with _socket.socket(_socket.AF_INET, _socket.SOCK_STREAM) as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _match(cards: Sequence[Optional[str]], workers: Sequence) -> Optional[List]:
    """One distinct worker per rank whose cards hold the rank's card (any
    worker for a CPU rank), or None: a small backtracking search, the
    ranks with the fewest candidates first."""
    cand = [[w for w in workers if c is None or c in w.cards] for c in cards]
    order = sorted(range(len(cards)), key=lambda r: len(cand[r]))
    out: List = [None] * len(cards)
    used: set = set()

    def place(i: int) -> bool:
        if i == len(order):
            return True
        r = order[i]
        for w in cand[r]:
            if w.wid not in used:
                used.add(w.wid)
                out[r] = w
                if place(i + 1):
                    return True
                used.discard(w.wid)
        return False

    return out if place(0) else None


class _WorkerHandle:
    __slots__ = ("wid", "proc", "chan", "state", "last_seen", "job",
                 "spawned_at", "devices", "device_name", "boot_s",
                 "ready_s", "max_gap_s", "cards")

    def __init__(self, wid: int, proc: subprocess.Popen,
                 cards: Sequence[str] = ()):
        self.wid = wid
        self.proc = proc
        #: the machine's card ids this worker sees (its
        #: CUDA_VISIBLE_DEVICES, in its own order); empty on the CPU
        self.cards = list(cards)
        self.chan: Optional[protocol.Channel] = None
        # starting (spawned) | booting (connected: torch, the CUDA
        # context) | idle (ready) | busy | dead
        self.state = "starting"
        self.last_seen = time.time()
        self.job: Optional[_Job] = None
        self.spawned_at = time.time()
        # from the ``ready`` frame: the pool the worker sees, its card's
        # name, its torch import + CUDA context seconds, and the seconds
        # from spawn to ready
        self.devices: Optional[int] = None
        self.device_name: Optional[str] = None
        self.boot_s: Optional[float] = None
        self.ready_s: Optional[float] = None
        #: longest silence between two frames since the channel connected
        self.max_gap_s = 0.0

    def info(self) -> Dict[str, Any]:
        return {"pid": self.proc.pid, "state": self.state,
                "devices": self.devices, "device_name": self.device_name,
                "boot_s": self.boot_s, "ready_s": self.ready_s,
                "max_heartbeat_gap_s": self.max_gap_s}


class _StreamTable:
    """The client-held Requests a worker streams into (rid -> Request).

    A ``finish`` frame moves its request to a bounded table of finished
    ones instead of dropping it, so a token frame that arrives after it
    is still applied rather than lost."""

    _KEEP_FINISHED = 4096

    def __init__(self):
        self._lock = threading.Lock()
        self._live: Dict[str, Any] = {}  # guarded-by: _lock
        self._finished: "collections.OrderedDict[str, Any]" = \
            collections.OrderedDict()  # guarded-by: _lock

    def track(self, req) -> None:
        with self._lock:
            self._live[req.rid] = req

    def _get(self, rid, finish: bool):
        with self._lock:
            req = self._live.pop(rid, None) if finish else self._live.get(rid)
            if req is None:
                return self._finished.get(rid)
            if finish:
                self._finished[rid] = req
                while len(self._finished) > self._KEEP_FINISHED:
                    self._finished.popitem(last=False)
            return req

    def apply_stream(self, msg: Dict[str, Any]) -> None:
        req = self._get(msg.get("rid"), finish=False)
        if req is None:
            return
        from repro_torch.serve.request import RequestState
        if req.admitted_at is None and msg.get("admitted_at") is not None:
            req.admitted_at = msg["admitted_at"]
        if req.first_token_at is None and msg.get("first_token_at") is not None:
            req.first_token_at = msg["first_token_at"]
        if req.state == RequestState.QUEUED:
            req.state = RequestState.RUNNING
        req.tokens.extend(msg.get("tokens", ()))
        req.token_times.extend(msg.get("times", ()))

    def apply_finish(self, msg: Dict[str, Any]) -> None:
        req = self._get(msg.get("rid"), finish=True)
        if req is None or req.done():
            return
        from repro_torch.serve.request import RequestState
        req._finish(RequestState[msg["state"]], msg.get("error"))
        if msg.get("finished_at") is not None:
            req.finished_at = msg["finished_at"]


def _visible_cards() -> List[str]:
    """The card ids this process may hand out: its own
    ``CUDA_VISIBLE_DEVICES`` when set, else every card of the machine."""
    env = os.environ.get("CUDA_VISIBLE_DEVICES")
    if env is not None:
        return [c for c in env.split(",") if c.strip()]
    import torch
    return [str(i) for i in range(torch.cuda.device_count())]


class SubprocessTransport(Transport):
    """Pool of worker daemon processes executing pickled task calls."""

    name = "subprocess"
    #: marks transports whose submit crosses a process boundary — the
    #: agent switches to the picklable remote-dispatch path on this flag
    remote = True

    _pool_seq = itertools.count()

    def __init__(self, max_workers: int = 2, *,
                 worker_devices: int = 2,
                 device=None,
                 heartbeat_s: float = 0.2,
                 heartbeat_timeout_s: float = 3.0,
                 poll_s: float = 0.05,
                 start_timeout_s: float = 120.0,
                 drain_timeout_s: float = 120.0,
                 max_respawns: Optional[int] = None,
                 policy: Optional[FailurePolicy] = None,
                 env: Optional[Dict[str, str]] = None):
        import socket as _socket

        from repro_torch.launch.mesh import resolve_device
        self.capacity = max_workers
        #: the devices one worker holds: a lease wider than this, or of
        #: distinct cards, runs as a gang (``needs_gang``)
        self.worker_devices = worker_devices
        #: the workers' device type: the card unless the caller asks for
        #: the CPU (raises here, in the parent, without a GPU)
        self.device = resolve_device(device).type
        self._cards = _visible_cards() if self.device == "cuda" else []
        self._heartbeat_s = heartbeat_s
        #: silence after which the monitor declares a worker hung
        self.heartbeat_timeout_s = max(heartbeat_timeout_s, 3 * heartbeat_s)
        self._poll_s = poll_s
        self._start_timeout_s = start_timeout_s
        self._drain_timeout_s = drain_timeout_s
        #: lifetime cap on respawns (default: 16, or 4 a worker slot)
        self._respawn_cap = (max_respawns if max_respawns is not None
                             else max(16, 4 * max_workers))
        self._env = env
        # respawn backoff + attempt deadlines; the default keeps the first
        # respawn near-immediate but makes a crash-looping slot back off
        # exponentially instead of burning the lifetime cap in seconds
        self._policy = policy if policy is not None else FailurePolicy(
            backoff_base_s=0.1, backoff_factor=2.0, backoff_max_s=5.0,
            jitter=0.1)

        self._cond = threading.Condition()
        self._workers: Dict[int, _WorkerHandle] = {}  # guarded-by: _cond
        self._queue: Deque[Union[_Job, _Gang]] = collections.deque()  # guarded-by: _cond
        self._inflight: Dict[int, _Job] = {}  # guarded-by: _cond (jid -> job)
        self._closed = False  # guarded-by: _cond
        self._respawns = 0  # guarded-by: _cond
        self._crash_streak: Dict[int, int] = {}  # guarded-by: _cond
        self._respawn_due: Dict[int, float] = {}  # guarded-by: _cond
        self._respawn_log: List[Dict[str, Any]] = []  # guarded-by: _cond
        self._jid = itertools.count()

        #: rid -> client-held Request the worker streams into
        self._streams = _StreamTable()

        self._listener = _socket.socket(_socket.AF_INET, _socket.SOCK_STREAM)
        self._listener.setsockopt(_socket.SOL_SOCKET, _socket.SO_REUSEADDR, 1)
        self._listener.bind(("127.0.0.1", 0))
        self._listener.listen(max_workers + 4)
        self._listener.settimeout(0.2)
        self._port = self._listener.getsockname()[1]

        pool_id = next(self._pool_seq)
        with self._cond:
            for wid in range(max_workers):
                self._workers[wid] = self._spawn_locked(wid)
        self._threads = [
            threading.Thread(target=self._accept_loop,
                             name=f"rc-exec-accept-{pool_id}", daemon=True),
            threading.Thread(target=self._dispatch_loop,
                             name=f"rc-exec-dispatch-{pool_id}", daemon=True),
            threading.Thread(target=self._monitor_loop,
                             name=f"rc-exec-monitor-{pool_id}", daemon=True),
        ]
        for t in self._threads:
            t.start()

    # -- public --------------------------------------------------------------

    def submit(self, fn: Callable, *args,
               service_control=None,
               on_done: Optional[Callable[[Future], None]] = None,
               label: Optional[str] = None,
               attempt_timeout_s: Optional[float] = None,
               **kwargs) -> Future:
        """Ship ``fn(*args, **kwargs)`` to an idle worker.

        Raises ``TypeError`` (naming the offending closure/capture)
        synchronously if the call is unpicklable, and ``RuntimeError`` if
        the transport is shut down.  Execution errors travel through the
        returned Future.  ``on_done`` fires exactly once on a transport
        thread after the Future resolves — never on the submitter's
        thread, so callers may hold scheduling locks while submitting.
        ``attempt_timeout_s`` (default: the transport policy's) bounds
        how long this attempt may run once dispatched before the monitor
        declares the worker hung and fails the Future.
        """
        # the fn's contract first (cheap); the arguments are pickled once,
        # for the payload, and only a failure walks them for the leaf
        pickling.ensure_picklable(fn, transport=self.name)
        try:
            payload = pickling.format_payload(
                fn, args, kwargs, service=service_control is not None)
        except Exception:  # noqa: BLE001 — re-raised, the leaf named first
            pickling.ensure_picklable(fn, args, kwargs, transport=self.name)
            raise
        if attempt_timeout_s is None:
            attempt_timeout_s = self._policy.attempt_timeout_s
        job = _Job(next(self._jid), payload,
                   label or getattr(fn, "__qualname__", repr(fn)),
                   service_control, on_done,
                   attempt_timeout_s=attempt_timeout_s)
        with self._cond:
            if self._closed:
                raise RuntimeError("SubprocessTransport is shut down")
            self._queue.append(job)
            self._cond.notify_all()
        return job.future

    def needs_gang(self, devices: Sequence) -> bool:
        """Whether one worker cannot hold a lease of ``devices``: distinct
        cards (one process holds one card's communicator), or more
        devices than a worker's pool."""
        from repro_torch.core.communicator import device_id, device_type

        if len(devices) <= 1:
            return False
        if (device_type(devices[0]) == "cuda"
                and len({device_id(d) for d in devices}) > 1):
            return True
        return len(devices) > self.worker_devices

    def submit_gang(self, fn: Callable, devices: Sequence, *args,
                    on_done: Optional[Callable[[Future], None]] = None,
                    label: Optional[str] = None,
                    attempt_timeout_s: Optional[float] = None,
                    **kwargs) -> Future:
        """Run ``fn(rendezvous, *args, **kwargs)`` on ``len(devices)`` idle
        workers at once, rank r on a worker that sees leased device r;
        ``rendezvous`` is the rank's part of the gang (module docstring).

        Returns one Future: rank 0's result once every rank has returned,
        or the first failure.  Raises ``ValueError`` at once for a gang
        wider than the pool, or one whose cards no set of worker slots
        holds, and ``TypeError`` for an unpicklable call.
        ``attempt_timeout_s`` bounds each rank's attempt, as in ``submit``,
        and also the process group's rendezvous and collectives
        (``GROUP_TIMEOUT_S`` when the attempt has no deadline).
        """
        from repro_torch.core.communicator import device_id, device_type

        n = len(devices)
        if n > self.capacity:
            raise ValueError(
                f"a gang of {n} ranks is wider than this pool of "
                f"{self.capacity} workers")
        if device_type(devices[0]) == "cuda":
            if self.device != "cuda":
                raise ValueError("a gang over CUDA devices needs a pool on "
                                 f"the card, not on the {self.device}")
            idx = [device_id(d) for d in devices]
            if max(idx) >= len(self._cards):
                raise ValueError(f"leased cards {idx}: this pool sees "
                                 f"{len(self._cards)}")
            cards: List[Optional[str]] = [self._cards[i] for i in idx]
            backend = "nccl" if len(set(cards)) == n else "gloo"
            slots = [SimpleNamespace(wid=w, cards=self._cards_for(w))
                     for w in range(self.capacity)]
            if _match(cards, slots) is None:
                raise ValueError(
                    f"no {n} worker slots hold the leased cards {cards} "
                    f"(each slot holds {self.worker_devices} card(s))")
        else:
            cards, backend = [None] * n, "gloo"
        pickling.ensure_picklable(fn, transport=self.name)
        try:
            payload = pickling.format_payload(fn, args, kwargs, service=False)
        except Exception:  # noqa: BLE001 — re-raised, the leaf named first
            pickling.ensure_picklable(fn, args, kwargs, transport=self.name)
            raise
        if attempt_timeout_s is None:
            attempt_timeout_s = self._policy.attempt_timeout_s
        label = label or getattr(fn, "__qualname__", repr(fn))
        gang = _Gang(on_done, cards, backend,
                     GROUP_TIMEOUT_S if attempt_timeout_s is None
                     else attempt_timeout_s)
        for r in range(n):
            job = _Job(next(self._jid), payload, f"{label} [rank {r} of {n}]",
                       None, None, attempt_timeout_s=attempt_timeout_s,
                       gang=gang, rank=r)
            job.on_done = lambda fut, j=job: self._on_rank_done(j, fut)
            gang.jobs.append(job)
        with self._cond:
            if self._closed:
                raise RuntimeError("SubprocessTransport is shut down")
            self._queue.append(gang)
            self._cond.notify_all()
        return gang.future

    def shutdown(self, wait: bool = True) -> None:
        """Stop the pool.  ``wait=True`` drains in-flight attempts (up to
        ``drain_timeout_s``) then asks workers to exit; ``wait=False``
        terminates worker processes immediately and fails their Futures.
        Either way every worker process is reaped — no orphans."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            queued = list(self._queue)
            self._queue.clear()
            inflight = list(self._inflight.values())
            workers = list(self._workers.values())
            self._cond.notify_all()
        for job in queued:  # a task or a whole gang
            self._resolve(job, exc=RuntimeError(
                "transport shut down before dispatch"))
        if wait:
            deadline = time.time() + self._drain_timeout_s
            for job in inflight:
                try:
                    job.future.result(timeout=max(0.0,
                                                  deadline - time.time()))
                except Exception:  # noqa: BLE001 — outcome lives in the Future
                    pass
            for w in workers:
                if w.chan is not None and w.state != "dead":
                    try:
                        w.chan.send({"type": "shutdown"})
                    except (protocol.ConnectionClosed, OSError):
                        pass
        self._reap_all(workers, grace_s=2.0 if wait else 0.2)
        # any Future still unresolved (wait=False, or a drain that timed
        # out on a hung worker) must resolve now — never a hang
        for job in inflight:
            if not job.future.done():
                self._resolve(job, exc=WorkerCrashed(
                    job.worker_id if job.worker_id is not None else -1,
                    None, job.label,
                    "transport shutdown" + ("" if wait else "(wait=False)")))
        try:
            self._listener.close()
        except OSError:
            pass
        for t in self._threads:
            t.join(timeout=1.0)

    def worker_pids(self) -> List[int]:
        """PIDs of live worker processes (test/diagnostic surface)."""
        with self._cond:
            return [w.proc.pid for w in self._workers.values()
                    if w.state != "dead" and w.proc.poll() is None]

    def worker_info(self) -> Dict[int, Dict[str, Any]]:
        """Per worker slot: pid, state, the pool and card it reported,
        boot seconds (torch import + CUDA context) and seconds from spawn
        to ``ready``, and the longest silence between two of its frames."""
        with self._cond:
            return {wid: w.info() for wid, w in self._workers.items()}

    def wait_ready(self, timeout: float) -> Dict[int, Dict[str, Any]]:
        """Block until every worker slot has sent ``ready``; returns
        ``worker_info()``.  Raises TimeoutError after ``timeout`` s."""
        deadline = time.time() + timeout
        with self._cond:
            while not all(w.ready_s is not None and w.state != "dead"
                          for w in self._workers.values()):
                left = deadline - time.time()
                if left <= 0 or self._closed:
                    raise TimeoutError(
                        f"workers not ready after {timeout:.0f}s: "
                        f"{ {wid: w.state for wid, w in self._workers.items()} }")
                self._cond.wait(min(left, 0.1))
            return {wid: w.info() for wid, w in self._workers.items()}

    def stats(self) -> Dict[str, Any]:
        """One-lock snapshot of pool health and the respawn history."""
        with self._cond:
            states = collections.Counter(
                w.state for w in self._workers.values())
            now = time.time()
            return {
                "respawns": self._respawns,
                "respawn_log": [dict(r) for r in self._respawn_log],
                "respawn_pending": {
                    wid: max(0.0, due - now)
                    for wid, due in self._respawn_due.items()},
                "crash_streaks": {w: s for w, s in
                                  self._crash_streak.items() if s},
                "queued": len(self._queue),
                "inflight": len(self._inflight),
                "workers": dict(states),
            }

    # -- spawning / reaping ----------------------------------------------------

    def _cards_for(self, wid: int) -> List[str]:
        """Worker slot ``wid``'s share of the cards: worker_devices cards
        round-robin over the visible ones (every worker gets card 0 on a
        one-card machine); empty on the CPU.  A respawn keeps its slot's."""
        if self.device != "cuda":
            return []
        k = min(self.worker_devices, len(self._cards))
        return [self._cards[(wid * k + j) % len(self._cards)] for j in range(k)]

    def _spawn_locked(self, wid: int) -> _WorkerHandle:
        env = dict(os.environ if self._env is None else self._env)
        env["PYTHONPATH"] = os.pathsep.join(p for p in sys.path if p)
        env[POOL_ENV] = str(self.worker_devices)
        cards = self._cards_for(wid)
        # the worker's torch numbers its cards from 0
        env["CUDA_VISIBLE_DEVICES"] = ",".join(cards)
        cmd = [sys.executable, "-m", "repro_torch.core.exec.worker",
               "--host", "127.0.0.1", "--port", str(self._port),
               "--worker-id", str(wid), "--device", self.device,
               "--heartbeat-s", str(self._heartbeat_s)]
        proc = subprocess.Popen(cmd, env=env)
        return _WorkerHandle(wid, proc, cards)

    def _reap_all(self, workers: List[_WorkerHandle], grace_s: float) -> None:
        for w in workers:
            if w.proc.poll() is None:
                w.proc.terminate()
        deadline = time.time() + grace_s
        for w in workers:
            try:
                w.proc.wait(timeout=max(0.0, deadline - time.time()))
            except subprocess.TimeoutExpired:
                w.proc.kill()
                w.proc.wait()  # noqa: TMO001 — SIGKILL'd: reap cannot hang
            if w.chan is not None:
                w.chan.close()

    # -- accept / receive ------------------------------------------------------

    def _accept_loop(self) -> None:
        import socket as _socket
        while True:
            with self._cond:
                if self._closed:
                    return
            try:
                sock, _ = self._listener.accept()
            except _socket.timeout:
                continue
            except OSError:
                return  # listener closed under us: shutting down
            chan = protocol.Channel(sock)
            try:
                hello = chan.recv(timeout=10.0)
            except (protocol.ConnectionClosed, _socket.timeout):
                chan.close()
                continue
            wid = hello.get("worker_id")
            with self._cond:
                w = self._workers.get(wid)
                if (w is None or w.state == "dead"
                        or w.proc.pid != hello.get("pid")):
                    stale = True  # a replaced worker's late connection
                else:
                    stale = False
                    chan.fault_filter = self._fault_filter_for(wid)
                    w.chan = chan
                    # heartbeats are watched from here; tasks wait for
                    # ``ready``, so no attempt's clock counts the boot
                    w.state = "booting"
                    w.last_seen = time.time()
            if stale:
                chan.close()
            else:
                threading.Thread(target=self._recv_loop, args=(w, chan),
                                 name=f"rc-exec-recv-{wid}",
                                 daemon=True).start()

    @staticmethod
    def _fault_filter_for(wid: int):
        """Per-frame chaos filter for a worker channel: consults the
        armed injector's ``protocol.recv`` site so a planned fault can
        drop or delay an RPC reply (recovery then rides the attempt
        deadline, like a real lost result would)."""
        def _filter(msg: Dict[str, Any]):
            inj = rfaults.active()
            if inj is None:
                return None
            return inj.fire("protocol.recv", worker=wid,
                            mtype=msg.get("type"), task=msg.get("task_id"))
        return _filter

    def _recv_loop(self, w: _WorkerHandle, chan: protocol.Channel) -> None:
        while True:
            try:
                msg = chan.recv()  # noqa: TMO001 — heartbeat monitor backstops a dead peer
            except protocol.ConnectionClosed:
                self._worker_lost(w, "channel closed")
                return
            mtype = msg.get("type")
            now = time.time()
            with self._cond:
                w.max_gap_s = max(w.max_gap_s, now - w.last_seen)
                w.last_seen = now
                if mtype == "ready":
                    w.devices = msg.get("devices")
                    w.device_name = msg.get("device_name")
                    w.boot_s = msg.get("boot_s")
                    w.ready_s = now - w.spawned_at
                    if w.state == "booting":
                        w.state = "idle"
                    self._cond.notify_all()
            if mtype == "result":
                self._on_result(w, msg)
            elif mtype == "stream":
                self._streams.apply_stream(msg)
            elif mtype == "finish":
                self._streams.apply_finish(msg)

    # -- dispatch --------------------------------------------------------------

    def _dispatch_loop(self) -> None:
        while True:
            sends: List[tuple] = []
            stranded: Optional[_Gang] = None
            with self._cond:
                while not sends and stranded is None:
                    if self._closed:
                        return
                    stranded = self._stranded_head_locked()
                    if stranded is not None:
                        break
                    picked = self._pick_locked()
                    if not picked:
                        self._cond.wait(0.5)
                        if self._closed:
                            return
                        continue
                    gang = picked[0][0].gang
                    held = gang.future if gang is not None else picked[0][0].future
                    if not held.set_running_or_notify_cancel():
                        continue  # cancelled while queued (agent close)
                    now = time.time()
                    port = _free_port() if gang is not None else None
                    for job, w in picked:
                        w.state = "busy"
                        w.job = job
                        job.worker_id = w.wid
                        if job.attempt_timeout_s is not None:
                            job.deadline = now + job.attempt_timeout_s
                        self._inflight[job.jid] = job
                        frame = {"type": "task", "task_id": job.jid,
                                 "payload": job.payload}
                        if gang is not None:
                            frame["rendezvous"] = gang.rendezvous(job.rank, w, port)
                        sends.append((job, w, frame))
            if stranded is not None and stranded.future.set_running_or_notify_cancel():
                self._resolve(stranded, exc=RuntimeError(
                    f"a gang over cards {stranded.cards} can no longer be "
                    "placed: the pool's respawn cap is spent and too few "
                    "worker slots are alive or due for respawn"))
            for job, w, frame in sends:
                try:
                    # chaos site first: an injected crash/stall frame lands
                    # before the task, so the fault deterministically hits
                    # the attempt being dispatched (no result/death race)
                    self._maybe_inject_dispatch_fault(job, w)
                    w.chan.send(frame)
                except (protocol.ConnectionClosed, OSError):
                    self._worker_lost(w, "send failed")
                    continue
                if job.service_control is not None:
                    threading.Thread(
                        target=self._bridge_loop, args=(job, w),
                        name=f"rc-exec-bridge-{job.jid}", daemon=True).start()

    def _stranded_head_locked(self) -> Optional[_Gang]:
        """Pop and return the queue head if it is a gang that no set of
        the pool's live slots, and those due for respawn, can place: a
        slot that died past the respawn cap stays dead, so the gang would
        wait at the head forever and hold up every task behind it."""
        if not self._queue or not isinstance(self._queue[0], _Gang):
            return None
        live = [w for w in self._workers.values()
                if w.state != "dead" or w.wid in self._respawn_due]
        if _match(self._queue[0].cards, live) is not None:
            return None
        return self._queue.popleft()

    def _pick_locked(self) -> List[tuple]:
        """The queue head's (job, worker) pairs: one idle worker for a
        task, one for each rank of a gang (all of them, or the gang waits
        at the head)."""
        if not self._queue:
            return []
        idle = [w for w in self._workers.values()
                if w.state == "idle" and w.chan is not None]
        head = self._queue[0]
        if isinstance(head, _Gang):
            placed = _match(head.cards, idle)
            if placed is None:
                return []
            self._queue.popleft()
            return list(zip(head.jobs, placed))
        if not idle:
            return []
        return [(self._queue.popleft(), idle[0])]

    def _maybe_inject_dispatch_fault(self, job: _Job,
                                     w: _WorkerHandle) -> None:
        """``transport.dispatch`` chaos site: a planned fault frame is
        sent just ahead of the task frame, so the crash (worker exits
        with the attempt assigned but unfinished) or stall (worker goes
        heartbeat-silent while the attempt runs) hits exactly the
        dispatch the plan named."""
        inj = rfaults.active()
        if inj is None:
            return
        act = inj.fire("transport.dispatch", worker=w.wid, task=job.jid,
                       label=job.label)
        if act is None:
            return
        if act["action"] == "crash_worker":
            w.chan.send({"type": "die"})
        elif act["action"] == "stall_heartbeat":
            w.chan.send({"type": "stall",
                         "for_s": float(act.get("for_s", 1.0))})

    # -- results / faults ------------------------------------------------------

    def _on_result(self, w: _WorkerHandle, msg: Dict[str, Any]) -> None:
        with self._cond:
            w.last_seen = time.time()
            self._crash_streak[w.wid] = 0  # a result proves the slot healthy
            job = self._inflight.pop(msg["task_id"], None)
            if w.job is job:
                w.job = None
            if w.state == "busy":
                w.state = "idle"
            self._cond.notify_all()
        if job is None:
            return  # already failed by the monitor (late result)
        status = msg.get("status")
        if status == "ok":
            self._resolve(job, value=msg.get("value"))
        elif status == "preempted":
            self._resolve(job, exc=ServicePreempted(msg.get("state")))
        else:
            err = msg.get("error") or {}
            self._resolve(job, exc=RemoteTaskError(
                err.get("etype", "Exception"), err.get("message", ""),
                err.get("traceback", "")))

    def _worker_lost(self, w: _WorkerHandle, reason: str,
                     only_if_job: Optional[_Job] = None) -> None:
        """Kill ``w``, fail its attempt and respawn its slot (under the
        cap and backoff).  With ``only_if_job``, do nothing unless ``w``
        still runs that job: a gang's kill must not land on a worker that
        has since taken up other work."""
        with self._cond:
            if w.state == "dead":
                return
            if only_if_job is not None and w.job is not only_if_job:
                return
            if self._closed:
                w.state = "dead"
                return  # shutdown() owns reaping and future resolution
            w.state = "dead"
            job, w.job = w.job, None
            if job is not None:
                self._inflight.pop(job.jid, None)
            pid = w.proc.pid
            chan = w.chan
            if self._respawns < self._respawn_cap:
                self._respawns += 1
                streak = self._crash_streak.get(w.wid, 0) + 1
                self._crash_streak[w.wid] = streak
                delay = self._policy.backoff_s(streak,
                                               key=f"respawn.{w.wid}")
                self._respawn_log.append({
                    "worker": w.wid, "attempt": self._respawns,
                    "streak": streak, "delay_s": delay})
                if delay <= 0:
                    self._workers[w.wid] = self._spawn_locked(w.wid)
                else:
                    # the monitor performs the spawn once the backoff
                    # elapses; until then the dead handle holds the slot
                    self._respawn_due[w.wid] = time.time() + delay
            self._cond.notify_all()
        if w.proc.poll() is None:
            w.proc.terminate()
        try:
            w.proc.wait(timeout=2.0)
        except subprocess.TimeoutExpired:
            w.proc.kill()
            w.proc.wait()  # noqa: TMO001 — SIGKILL'd: reap cannot hang
        if chan is not None:
            chan.close()
        if job is not None:
            self._resolve(job, exc=WorkerCrashed(w.wid, pid, job.label,
                                                 reason))

    def _monitor_loop(self) -> None:
        while True:
            with self._cond:
                if self._closed:
                    return
                now = time.time()
                for wid, due in list(self._respawn_due.items()):
                    if due <= now:  # backoff elapsed: perform the respawn
                        del self._respawn_due[wid]
                        self._workers[wid] = self._spawn_locked(wid)
                        self._cond.notify_all()
                workers = [(w, w.job) for w in self._workers.values()]
            for w, job in workers:
                if w.state == "dead":
                    continue
                if w.proc.poll() is not None:
                    # fast path: process exit (crash/SIGKILL) — detected at
                    # poll cadence, without waiting out a heartbeat timeout
                    self._worker_lost(
                        w, f"process exited with code {w.proc.returncode}")
                elif (w.chan is not None  # a long frame arriving or decoding is life
                      and min(now - w.last_seen, w.chan.quiet_s(now))
                      > self.heartbeat_timeout_s):
                    self._worker_lost(
                        w, f"no heartbeat for "
                           f"{now - w.last_seen:.1f}s (hung?)")
                elif (w.state == "busy" and job is not None
                      and job.deadline is not None and now > job.deadline):
                    # per-attempt deadline (FailurePolicy.attempt_timeout_s):
                    # also the recovery path for a dropped result reply
                    self._worker_lost(
                        w, f"attempt exceeded its "
                           f"{job.attempt_timeout_s:.1f}s deadline")
                elif (w.state in ("starting", "booting")
                      and now - w.spawned_at > self._start_timeout_s):
                    self._worker_lost(w, f"not ready after {self._start_timeout_s:.0f}s "
                                         f"({w.state}: start timeout)")
            time.sleep(self._poll_s)

    def _on_rank_done(self, job: _Job, fut: Future) -> None:
        """One rank of a gang resolved: complete the gang with rank 0's
        result once every rank has returned, or fail it at the first rank
        that did not and kill the workers of the ranks still running
        (they may wait in a collective for the failed one)."""
        gang = job.gang
        outcome = gang.record(job.rank, fut)
        if outcome == "ok":
            self._resolve(gang, value=gang.value())
        elif outcome == "failed":
            self._resolve(gang, exc=fut.exception(timeout=0))
            for other in gang.jobs:
                with self._cond:
                    w = self._workers.get(other.worker_id)
                if w is not None:
                    self._worker_lost(
                        w, f"rank {job.rank} of its gang failed",
                        only_if_job=other)

    def _resolve(self, job: Union[_Job, _Gang], value: Any = None,
                 exc: Optional[BaseException] = None) -> None:
        try:
            if exc is not None:
                job.future.set_exception(exc)
            else:
                job.future.set_result(value)
        except Exception:  # noqa: BLE001 — future already cancelled/resolved
            pass
        if job.on_done is not None:
            try:
                job.on_done(job.future)
            except Exception:  # noqa: BLE001 — callbacks must not kill the pool
                import traceback
                traceback.print_exc()

    # -- service bridge --------------------------------------------------------

    def _bridge_loop(self, job: _Job, w: _WorkerHandle) -> None:
        """Pump the caller-held ServiceControl down to the worker replica
        for the lifetime of one service attempt."""
        control = job.service_control
        sent_stop = sent_drain = sent_preempt = False
        while not job.future.done():
            entries = control.take_requests()
            for entry in entries:
                req = getattr(entry, "request", entry)
                if getattr(req, "rid", None) is not None:
                    self._streams.track(req)
                try:
                    w.chan.send({"type": "control", "op": "submit_request",
                                 "data": protocol.dumps(entry)})
                except (protocol.ConnectionClosed, OSError):
                    return
            try:
                if control.stop_requested() and not sent_stop:
                    sent_stop = True
                    w.chan.send({"type": "control", "op": "stop"})
                if control.drain_requested() and not sent_drain:
                    sent_drain = True
                    w.chan.send({"type": "control", "op": "drain"})
                if control.preempt_requested() and not sent_preempt:
                    sent_preempt = True
                    w.chan.send({"type": "control", "op": "preempt"})
            except (protocol.ConnectionClosed, OSError):
                return
            time.sleep(0.005)


class DistributedTransport(SubprocessTransport):
    """Cross-node flavour of the subprocess pool (the port's counterpart
    of the JAX package's ``JaxDistributedTransport``, under its spec
    string ``"jax-distributed"``).

    The worker daemon has the multi-host hook (``repro_torch.core.exec.worker
    --dist-init-method ...`` joins a ``torch.distributed`` process group),
    but there is no fabric behind multi-host coordinates on one machine —
    so requesting real multi-host init raises a specific error instead of
    hanging on a rendezvous that will never answer.
    Constructed with no coordinates it behaves exactly like
    :class:`SubprocessTransport` (process-isolated workers on this host).
    """

    name = "jax-distributed"

    def __init__(self, init_method: Optional[str] = None,
                 world_size: Optional[int] = None,
                 rank: Optional[int] = None, **kwargs):
        multi_host = (init_method is not None
                      or (world_size or 1) > 1
                      or (rank or 0) != 0)
        if multi_host:
            raise NotImplementedError(
                "cross-node multi-host init requested "
                f"(init_method={init_method!r}, world_size={world_size}"
                f", rank={rank}) but no multi-host fabric exists in this "
                "build. The worker daemon already accepts "
                "--dist-init-method/--dist-world-size/--dist-rank "
                "(repro_torch.core.exec.worker) and calls "
                "torch.distributed.init_process_group with them — point the "
                "pool at real hosts to enable it. For process-isolated "
                "workers on this host, construct without coordinates (or "
                "use SubprocessTransport).")
        super().__init__(**kwargs)
