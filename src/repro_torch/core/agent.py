"""RemoteAgent: master–worker task executor (paper Fig. 3; mirror of
``repro.core.agent``).

The master holds the queue; workers execute tasks on carved communicators.
Execution is **event-driven**: ``submit_async`` enqueues tasks and returns
immediately, and a background dispatcher thread launches tasks as devices
free up.  The dispatcher sleeps on a condition variable and is woken by
submissions, task completions, and pilot capacity changes — there is no
polling spin; a bounded wait is used only while straggler speculation is
actually possible.

Execution is layered ``PilotManager -> Pilot -> Transport``: the agent
owns *when* an attempt runs (this dispatcher), and a pluggable
:class:`repro_torch.core.transport.Transport` owns *where* it runs — the
default ``InProcessTransport`` is a thread pool in this process.  The JAX
package's cross-process transports (their picklable task body and its
result transitions) come with the port's ``core/exec/`` (ROADMAP.md
queue 1, item 6).

Runnability features the brief requires at scale:

* **fault isolation + retry** — a task exception (including simulated
  ``DeviceFailure``) is contained in its Task; failed devices are removed
  from the pilot pool and the task retries on a re-carved (possibly
  smaller) mesh — elastic degradation.  With a FailurePolicy on the
  description (``repro_torch.core.resilience``) the retry loop gains
  exponential backoff with deterministic
  jitter (retries park on ``Task.not_before``) and an end-to-end deadline
  across all attempts — a task that runs out of deadline fails
  *cleanly*: devices released, quotas balanced, callbacks fired;
* **straggler mitigation** — speculative duplicate execution when a task
  runs past ``straggler_factor x`` the median duration of its tag class;
  first completion wins, and the speculative lease is released under its
  own uid so the pool always recovers;
* **overhead accounting** — per-task communicator-build / queue / execute
  timings (reproduces the paper's Table 2 overhead decomposition);
* **per-group device quotas** — tasks carrying a ``group`` (their
  pipeline's name) never hold more devices concurrently than the group's
  quota (``set_quota``); over-quota tasks wait in the queue while other
  groups' tasks launch past them, so one wide pipeline cannot starve its
  siblings (Table-4 fairness).  Every grouped lease/release is recorded
  in ``lease_trace`` and ``group_peaks()`` so fairness is auditable;
* **checkpoint-aware retry** — a retried task whose description names a
  ``checkpoint_dir`` is re-submitted with ``resume_step`` set to the last
  completed step found there (the port's ``checkpoint.store``), instead
  of the task fn rediscovering it;
* **service tasks + priority preemption** — a ``service=True`` task is a
  long-running stage (e.g. a continuous-batching inference engine) that
  holds its lease and is driven through its ``ServiceControl``.  When
  higher-priority work is starved of devices or worker slots, the
  dispatcher requests preemption; the service checkpoints its state and
  raises ``ServicePreempted``, the lease is released, and the task is
  re-queued (no retry budget consumed) to resume with
  ``resume_state=<checkpoint>`` once capacity frees up.  Service tasks
  are never speculated and never pollute the straggler duration medians.

Historical bug notes (regression-tested in tests/test_scheduler.py and
tests/test_torch_runtime.py):
``Future.result(timeout=...)`` raises ``concurrent.futures.TimeoutError``,
which on Python 3.10 is NOT a subclass of builtin ``TimeoutError`` — the
old polling loop caught the builtin, so still-running tasks fell into the
generic handler and were popped as done.  The dispatcher design removes
result-polling entirely; the one remaining timed future wait (``close``)
catches ``concurrent.futures.TimeoutError`` explicitly.
"""
from __future__ import annotations

import collections
import concurrent.futures
import itertools
import statistics
import threading
import time
import traceback
from concurrent.futures import Future
from typing import Callable, Deque, Dict, List, Optional, Tuple

from repro_torch.checkpoint import store as ckpt_store
from repro_torch.core.pilot import Pilot
from repro_torch.core.task import (
    DeviceFailure, ServicePreempted, Task, TaskDescription, TaskState,
)
from repro_torch.core.transport import InProcessTransport, Transport

# Python 3.10: concurrent.futures.TimeoutError is distinct from the builtin;
# 3.11+ aliases them.  Catch both wherever a timed future wait happens.
_FUTURE_TIMEOUT_ERRORS = (TimeoutError, concurrent.futures.TimeoutError)


class RemoteAgent:
    _uid = itertools.count()

    def __init__(self, pilot: Pilot, *, max_workers: int = 4,
                 transport: Optional[Transport] = None,
                 straggler_factor: float = 3.0, straggler_min_s: float = 1.0,
                 straggler_check_s: float = 0.1,
                 lease_trace_limit: int = 10_000):
        self.pilot = pilot
        # an injected transport belongs to the caller (it may be shared
        # across agents); only a transport we created here is shut down
        # in close()
        self._own_transport = transport is None
        self._transport = transport if transport is not None else \
            InProcessTransport(max_workers)
        # the transport bounds in-flight attempts; an explicit transport's
        # capacity wins over the max_workers default
        self.max_workers = (self._transport.capacity
                            if self._transport.capacity is not None
                            else max_workers)
        self.straggler_factor = straggler_factor
        self.straggler_min_s = straggler_min_s
        self.straggler_check_s = straggler_check_s
        # _result_lock guards task result/state transitions (primary vs
        # speculative twin); _cond guards the scheduling state below.
        self._result_lock = threading.Lock()
        self._cond = threading.Condition()
        # straggler duration history lives with the scheduling state: its
        # readers (_wait_timeout_locked / _check_stragglers_locked) run
        # under _cond, so the writer must too (_on_worker_exit)
        self._durations: Dict[str, List[float]] = {}  # guarded-by: _cond
        self._pending: List[Task] = []  # guarded-by: _cond  (priority queue)
        self._running: Dict[str, Task] = {}  # guarded-by: _cond  (uid -> task)
        # uid -> (lease uid, fut)
        self._spec: Dict[str, Tuple[str, Future]] = {}  # guarded-by: _cond
        self._seq = itertools.count()             # FIFO tiebreak within priority
        self._order: Dict[str, int] = {}  # guarded-by: _cond
        # per-group quota state: quota caps, devices currently held per
        # group (speculative twins included), observed peaks, and an
        # auditable (time, group, delta, held-after) trace of every
        # grouped lease event
        self._quotas: Dict[str, int] = {}  # guarded-by: _cond
        self._group_held: Dict[str, int] = {}  # guarded-by: _cond
        self._group_peak: Dict[str, int] = {}  # guarded-by: _cond
        self._lease_sizes: Dict[str, Tuple[Optional[str], int]] = {}  # guarded-by: _cond
        self.lease_trace: Deque[Tuple[float, str, int, int]] = \
            collections.deque(maxlen=lease_trace_limit)  # guarded-by: _cond
        #: total preemption requests issued to service tasks (auditable)
        self.preemption_requests = 0  # guarded-by: _cond
        self._closed = False  # guarded-by: _cond
        pilot.add_capacity_listener(self._wake)
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="rc-dispatcher", daemon=True)
        self._dispatcher.start()

    # -- public --------------------------------------------------------------

    def submit_async(self, descriptions: List[TaskDescription],
                     on_complete: Optional[Callable[[Task], None]] = None,
                     ) -> List[Task]:
        """Enqueue tasks and return immediately (non-blocking).

        ``on_complete(task)`` fires once per task when it reaches a terminal
        state — after all retries, never while another attempt is possible.
        Callbacks run on worker threads; they may call ``submit_async``.
        """
        tasks = [Task(uid=f"task.{next(self._uid):06d}", description=d)
                 for d in descriptions]
        if on_complete is not None:
            for t in tasks:
                t.add_done_callback(on_complete)
        self._enqueue(tasks)
        return tasks

    def submit(self, descriptions: List[TaskDescription]) -> List[Task]:
        """Blocking submit: enqueue and wait for every task to finish."""
        tasks = self.submit_async(descriptions)
        self.wait(tasks)
        return tasks

    def execute(self, tasks: List[Task]) -> List[Task]:
        """Run pre-built Task objects to completion (respecting device
        capacity, priority order)."""
        self._enqueue([t for t in tasks if not t.finalized])
        self.wait(tasks)
        return tasks

    def wait(self, tasks: List[Task], timeout: Optional[float] = None) -> bool:
        """Block until all tasks are terminal; False on timeout."""
        deadline = None if timeout is None else time.time() + timeout
        for t in tasks:
            remaining = None if deadline is None else max(0.0, deadline - time.time())
            if not t.wait(remaining):
                return False
        return True

    # -- quotas ----------------------------------------------------------------

    def set_quota(self, group: str, max_devices: Optional[int]) -> None:
        """Cap the devices tasks of ``group`` may hold concurrently (None
        removes the cap).  Raising a quota wakes the dispatcher so newly
        admissible tasks launch immediately."""
        with self._cond:
            if max_devices is None:
                self._quotas.pop(group, None)
            else:
                if max_devices < 1:
                    raise ValueError(f"quota for {group!r} must be >= 1")
                self._quotas[group] = max_devices
            self._cond.notify_all()

    def quota(self, group: str) -> Optional[int]:
        with self._cond:
            return self._quotas.get(group)

    def group_peaks(self) -> Dict[str, int]:
        """Max devices each group was observed holding at once."""
        with self._cond:
            return dict(self._group_peak)

    def quota_violations(self) -> Dict[str, int]:
        """Groups whose observed peak exceeded their quota (empty = the
        enforcement invariant held for the recorded trace)."""
        with self._cond:
            return {g: peak for g, peak in self._group_peak.items()
                    if g in self._quotas and peak > self._quotas[g]}

    def close(self, timeout: Optional[float] = None) -> None:
        """Stop the dispatcher and drain workers (idempotent).  Queued
        tasks that never launched are CANCELED and finalized so waiters
        and completion callbacks are released, not left hanging."""
        self.pilot.remove_capacity_listener(self._wake)
        with self._cond:
            self._closed = True
            abandoned, self._pending = self._pending, []
            for t in abandoned:
                t.state = TaskState.CANCELED
                t.error = "agent closed before task launched"
                t.finalized = True
            specs = list(self._spec.values())  # snapshot under the cond:
            # workers pop from _spec concurrently
            service_controls = [
                t.description.control for t in self._running.values()
                if t.description.service and t.description.control is not None]
            self._cond.notify_all()
        # a service task never returns on its own — without a stop signal
        # the transport drain below would hang forever
        for c in service_controls:
            c.stop()
        for t in abandoned:
            self._finalize(t)
        for _, fut in specs:
            fut.cancel()
            try:
                fut.result(timeout=timeout if timeout is not None else 0)
            except _FUTURE_TIMEOUT_ERRORS:
                pass  # still running: the pool shutdown below will not wait
            except Exception:  # noqa: BLE001 — result already in the task
                pass
        if self._own_transport:
            self._transport.shutdown(wait=timeout is None or timeout > 0)

    def __enter__(self) -> "RemoteAgent":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- scheduling core -------------------------------------------------------

    def _enqueue(self, tasks: List[Task]) -> None:
        with self._cond:
            if self._closed:
                raise RuntimeError("RemoteAgent is closed")
            for t in tasks:
                self._order.setdefault(t.uid, next(self._seq))
                pol = t.description.policy
                if pol is not None and t.deadline is None:
                    # end-to-end deadline: one clock across all attempts,
                    # anchored at submission
                    t.deadline = pol.deadline_at(t.submitted_at)
            self._pending.extend(tasks)
            self._pending.sort(
                key=lambda t: (-t.description.priority, self._order[t.uid]))
            self._cond.notify_all()

    def _wake(self) -> None:
        with self._cond:
            self._cond.notify_all()

    def _dispatch_loop(self) -> None:
        while True:
            with self._cond:
                self._launch_ready_locked()
                self._fail_if_pool_dead_locked()
                if self._closed and not self._running and not self._spec:
                    return
                # Sleep until woken by submit/complete/release.  A bounded
                # wait is used only while speculation could trigger.
                self._cond.wait(self._wait_timeout_locked())

    def _wait_timeout_locked(self) -> Optional[float]:
        timeout: Optional[float] = None
        for task in self._running.values():
            d = task.description
            if (d.speculative and task.uid not in self._spec
                    and len(self._durations.get(d.kind, [])) >= 3):
                timeout = self.straggler_check_s
                break
        # a parked retry (backoff) or a pending deadline needs a timed
        # wake: nothing else is guaranteed to notify the condition then
        now = time.time()
        for t in self._pending:
            for at in (t.not_before, t.deadline):
                if at is not None and at > now:
                    w = (at - now) + 0.005
                    timeout = w if timeout is None else min(timeout, w)
        return timeout

    def _quota_headroom_locked(self, group: Optional[str]) -> Optional[int]:
        """Devices the group may still take (None = unconstrained)."""
        if group is None or group not in self._quotas:
            return None
        return self._quotas[group] - self._group_held.get(group, 0)

    def _record_lease_locked(self, group: Optional[str], delta: int) -> None:
        if group is None:
            return
        held = self._group_held.get(group, 0) + delta
        self._group_held[group] = held
        if delta > 0:
            self._group_peak[group] = max(self._group_peak.get(group, 0), held)
        self.lease_trace.append((time.time(), group, delta, held))

    def _submit_attempt_locked(self, task: Task, devices, lease_uid: str,
                               group) -> bool:
        """Hand one attempt to the transport; on submit failure (e.g. a
        shared transport was shut down) undo the lease/quota bookkeeping
        instead of letting the exception kill the dispatcher thread."""
        try:
            self._submit_to_transport(task, devices, lease_uid)
            return True
        except Exception as e:  # noqa: BLE001 — isolation boundary
            self._lease_sizes.pop(lease_uid, None)
            self._record_lease_locked(group, -len(devices))
            self.pilot.release(lease_uid)
            task.finished_at = time.time()
            task.error = f"transport rejected attempt: {type(e).__name__}: {e}"
            task.state = TaskState.FAILED
            task.finalized = True
            threading.Thread(target=self._finalize, args=(task,),
                             daemon=True).start()
            return False

    def _launch_ready_locked(self) -> None:
        if self._closed:
            return
        still: List[Task] = []
        starved: List[Task] = []  # blocked on capacity (not quota) — these
        # can justify preempting a lower-priority service task
        expired: List[Task] = []  # end-to-end deadline hit before launch
        now = time.time()
        for t in self._pending:
            d = t.description
            if t.deadline is not None and now >= t.deadline:
                # clean failure, not a crash: the task never launched,
                # so no lease/quota state exists to unwind
                t.finished_at = now
                t.error = ((t.error + "; ") if t.error else "") + (
                    f"end-to-end deadline exceeded after {t.attempts} "
                    f"attempt(s) (FailurePolicy.deadline_s="
                    f"{d.policy.deadline_s if d.policy else None})")
                t.state = TaskState.FAILED
                t.finalized = True
                expired.append(t)
                continue
            if t.not_before > now:
                still.append(t)  # parked by retry backoff
                continue
            if d.service and any(
                    s.description.priority > d.priority for s in starved):
                # a (possibly just-preempted) service must not re-grab
                # devices while strictly-higher-priority work is still
                # starved — otherwise preempt/relaunch thrashes, copying
                # the engine checkpoint in a tight loop
                still.append(t)
                continue
            if len(self._running) + len(self._spec) >= self.max_workers:
                still.append(t)
                starved.append(t)
                continue
            n = min(d.num_devices, max(len(self.pilot.alive_devices()), 1))
            headroom = self._quota_headroom_locked(d.group)
            if headroom is not None:
                if headroom < 1:
                    # over quota: this task waits, later (other-group)
                    # tasks still get considered — backpressure without
                    # head-of-line blocking (a preemption would not help:
                    # the group's own quota is the limit)
                    still.append(t)
                    continue
                # a wide task shrinks to its group's remaining share, the
                # same elastic-degradation contract as device failures
                n = min(n, headroom)
            devices = self.pilot.lease(n, t.uid)
            if devices is None:
                still.append(t)
                starved.append(t)
                continue
            t.state = TaskState.RUNNING
            self._running[t.uid] = t
            self._lease_sizes[t.uid] = (d.group, len(devices))
            self._record_lease_locked(d.group, len(devices))
            if not self._submit_attempt_locked(t, devices, t.uid, d.group):
                self._running.pop(t.uid, None)
        self._pending = still
        if expired:
            # callbacks fire outside the condition, like _fail_if_pool_dead
            threading.Thread(
                target=lambda: [self._finalize(t) for t in expired],
                daemon=True).start()
        self._maybe_preempt_locked(starved)
        self._check_stragglers_locked()

    def _maybe_preempt_locked(self, starved: List[Task]) -> None:
        """Ask ONE running service task to yield when strictly-higher-
        priority work is starved of devices or worker slots — the
        lowest-priority service first; if the starved work still cannot
        launch after that yield, the next dispatch pass escalates to the
        next service.  Cooperative: the service notices between work
        units, checkpoints, and raises ``ServicePreempted``; its lease is
        released on the way out.  One-at-a-time matters: every preemption
        costs a full engine checkpoint/restore cycle, so yielding every
        service at once for a one-device deficit doubles serving
        disruption for nothing."""
        if not starved:
            return
        top = max(t.description.priority for t in starved)
        victims = [
            t for t in self._running.values()
            if (t.description.service and t.description.control is not None
                and t.description.priority < top
                and t.state == TaskState.RUNNING)]
        if any(t.description.control.preempt_requested() for t in victims):
            return  # a yield is already in flight; let it land first
        if victims:
            victim = min(victims, key=lambda t: t.description.priority)
            victim.description.control.request_preempt()
            self.preemption_requests += 1

    def _fail_if_pool_dead_locked(self) -> None:
        if (self._pending and not self._running and not self._spec
                and not self.pilot.alive_devices()):
            dead, self._pending = self._pending, []
            for t in dead:
                t.state = TaskState.FAILED
                t.error = "pilot has no alive devices"
                t.finalized = True
            # fire callbacks outside the condition
            threading.Thread(target=lambda: [self._finalize(t) for t in dead],
                             daemon=True).start()

    def _check_stragglers_locked(self) -> None:
        now = time.time()
        for uid, task in list(self._running.items()):
            d = task.description
            # the lease release wakes the dispatcher before _on_worker_exit
            # removes the uid from _running — skip tasks already terminal
            if task.state != TaskState.RUNNING:
                continue
            if not d.speculative or uid in self._spec:
                continue
            hist = self._durations.get(d.kind, [])
            if len(hist) < 3 or task.started_at is None:
                continue
            if now - task.started_at <= max(
                    self.straggler_factor * statistics.median(hist),
                    self.straggler_min_s):
                continue
            if len(self._running) + len(self._spec) >= self.max_workers:
                continue
            headroom = self._quota_headroom_locked(d.group)
            if headroom is not None and headroom < 1:
                continue  # a speculative twin must not bust the quota
            lease_uid = f"{uid}.spec{task.attempts}"
            devices = self.pilot.lease(min(d.num_devices, 1), lease_uid)
            if devices is None:
                continue
            self._lease_sizes[lease_uid] = (d.group, len(devices))
            self._record_lease_locked(d.group, len(devices))
            try:
                fut = self._submit_to_transport(task, devices, lease_uid)
            except Exception:  # noqa: BLE001 — a dead transport must not
                # kill the dispatcher; the primary attempt is still running
                self._lease_sizes.pop(lease_uid, None)
                self._record_lease_locked(d.group, -len(devices))
                self.pilot.release(lease_uid)
                continue
            self._spec[uid] = (lease_uid, fut)

    # -- worker side -----------------------------------------------------------

    def _submit_to_transport(self, task: Task, devices, lease_uid: str):
        """Hand one attempt (the bound ``_run_one`` worker) to the
        transport."""
        return self._transport.submit(self._run_one, task, devices, lease_uid)

    def _run_one(self, task: Task, devices, lease_uid: str) -> None:
        d = task.description
        is_primary = lease_uid == task.uid
        if is_primary:
            # a speculative twin must not consume retry budget nor clobber
            # the primary's timing fields (a shrunken duration would drag
            # the straggler median down and cascade spurious speculation)
            task.attempts += 1
            task.overhead_s["queue"] = time.time() - task.submitted_at
        try:
            t0 = time.time()
            mesh_shape = (d.mesh_shape
                          if d.mesh_shape and len(devices) == _prod(d.mesh_shape)
                          else (len(devices),))
            mesh_axes = (d.mesh_axes if len(mesh_shape) == len(d.mesh_axes)
                         else ("data",))
            comm = self.pilot.carve(devices, mesh_shape, mesh_axes)
            if is_primary:
                task.overhead_s["communicator"] = time.time() - t0
                task.started_at = time.time()
            kwargs = {}
            if d.checkpoint_dir is not None:
                # checkpoint-aware contract: fn accepts resume_step=None on
                # the first attempt; retries get the last completed step
                kwargs["resume_step"] = d.resume_step
            if d.service:
                # service contract: fn accepts the control handle and (on
                # resume after preemption) its own checkpointed state
                kwargs["control"] = d.control
                kwargs["resume_state"] = d.resume_state
            result = d.fn(comm, *d.args, **kwargs)
            finished = time.time()
            with self._result_lock:
                if task.state == TaskState.DONE:
                    return  # a speculative twin won
                task.finished_at = finished
                task.result = result
                task.error = None  # a retry succeeded: stale error must not
                # make error-checking callers reject a DONE task
                task.state = TaskState.DONE
                # NB: the straggler duration history is _cond state — it is
                # recorded in _on_worker_exit when this completion is
                # finalized, not here under _result_lock
        except ServicePreempted as e:
            with self._result_lock:
                if task.state == TaskState.DONE:
                    return
                task.finished_at = time.time()
                d.resume_state = e.state
                task.preemptions += 1
                task.attempts -= 1  # preemption is a yield, not a failure
                task.state = TaskState.PREEMPTED
        except DeviceFailure as e:
            self.pilot.mark_failed(e.device_ids)
            with self._result_lock:
                if task.state == TaskState.DONE:
                    return
                task.finished_at = time.time()
                task.error = f"DeviceFailure{e.device_ids}"
                task.state = TaskState.FAILED
        except Exception as e:  # noqa: BLE001 — isolation boundary
            with self._result_lock:
                if task.state == TaskState.DONE:
                    return
                task.finished_at = time.time()
                task.error = f"{type(e).__name__}: {e}\n{traceback.format_exc()[-1500:]}"
                task.state = TaskState.FAILED
        finally:
            if task.state == TaskState.FAILED and d.checkpoint_dir is not None:
                # resolve the resume point HERE, on the worker thread —
                # a directory scan on slow storage must never run under
                # the scheduling condition in _on_worker_exit
                d.resume_step = ckpt_store.latest_step(d.checkpoint_dir)
            self.pilot.release(lease_uid)  # NB: the lease uid, not task.uid —
            # a speculative twin's lease differs and must be returned too
            self._on_worker_exit(task, lease_uid)

    def _on_worker_exit(self, task: Task, lease_uid: str) -> None:
        """One attempt (primary or speculative) finished running.  Decide —
        under the scheduling condition — whether the task is terminal,
        should retry, or must wait for an in-flight twin."""
        to_finalize = False
        with self._cond:
            group, leased_n = self._lease_sizes.pop(lease_uid, (None, 0))
            self._record_lease_locked(group, -leased_n)
            if lease_uid == task.uid:
                self._running.pop(task.uid, None)
            else:
                spec = self._spec.get(task.uid)
                if spec is not None and spec[0] == lease_uid:
                    self._spec.pop(task.uid, None)
            in_flight = task.uid in self._running or task.uid in self._spec
            if not task.finalized:
                if task.state == TaskState.DONE:
                    # first completion wins, even with a twin still running
                    task.finalized = True
                    to_finalize = True
                    if not task.description.service:
                        # a service run's duration is its lifetime, not a
                        # unit of work — it must not drag straggler medians
                        self._durations.setdefault(
                            task.description.kind, []).append(task.duration_s)
                elif task.state == TaskState.FAILED and not in_flight:
                    pol = task.description.policy
                    now = time.time()
                    budget_ok = (pol.allow_retry(task.attempts)
                                 if pol is not None
                                 else task.attempts
                                 <= task.description.max_retries)
                    deadline_ok = task.deadline is None or now < task.deadline
                    if (not self._closed and budget_ok and deadline_ok
                            and self.pilot.alive_devices()):
                        # checkpoint-aware retry: description.resume_step
                        # was already refreshed off-lock in _run_one.
                        # Under a FailurePolicy the retry is parked until
                        # its backoff elapses (deterministic jitter).
                        if pol is not None:
                            delay = pol.backoff_s(task.attempts,
                                                  key=task.uid)
                            if delay > 0:
                                task.not_before = now + delay
                                task.overhead_s["backoff"] = \
                                    task.overhead_s.get("backoff", 0.0) \
                                    + delay
                        task.state = TaskState.PENDING
                        self._pending.append(task)
                        self._pending.sort(key=lambda t: (
                            -t.description.priority, self._order[t.uid]))
                    else:
                        if not deadline_ok:
                            task.error = ((task.error + "; ")
                                          if task.error else "") + \
                                "end-to-end deadline exceeded (FailurePolicy)"
                        task.finalized = True
                        to_finalize = True
                elif task.state == TaskState.PREEMPTED and not in_flight:
                    if not self._closed and self.pilot.alive_devices():
                        # re-queue at the task's own priority: the work
                        # that preempted it sorts first, and the service
                        # resumes (resume_state already stashed) once
                        # devices free up again
                        if task.description.control is not None:
                            task.description.control._clear_preempt()
                        task.state = TaskState.PENDING
                        self._pending.append(task)
                        self._pending.sort(key=lambda t: (
                            -t.description.priority, self._order[t.uid]))
                    else:
                        task.state = TaskState.CANCELED
                        task.error = "agent closed while service was preempted"
                        task.finalized = True
                        to_finalize = True
            self._cond.notify_all()
        if to_finalize:
            self._finalize(task)

    def _finalize(self, task: Task) -> None:
        """Fire completion callbacks and release waiters (outside the
        scheduling condition)."""
        for cb in task._drain_callbacks():
            try:
                cb(task)
            except Exception:  # noqa: BLE001 — callbacks must not kill workers
                traceback.print_exc()


def _prod(xs):
    out = 1
    for x in xs:
        out *= x
    return out
