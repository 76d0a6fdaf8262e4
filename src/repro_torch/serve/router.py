"""EngineRouter: fleet serving over N ServeEngines (mirror of
``repro.serve.router``).

One router owns a shared request queue in front of N engines and admits
**load-aware**: each route reads the target's
:meth:`~repro_torch.serve.engine.ServeEngine.admission_signals` — slot
occupancy, page-pool pressure, queue depth and age, all snapshotted
under the engine's ``_lock`` — and sends the request to the engine with
the most headroom, holding it in the router queue when every engine is
saturated (backpressure instead of queue-stuffing the least-bad victim).

Engines run as *service bodies* in one of two modes:

* **thread mode** (default): the router spawns one thread per engine
  running ``engine.run_service(control)``.  Every engine thread launches
  its kernels on that thread's current CUDA stream.  Rolling restarts
  reuse the engine's preemption machinery: the router takes the engine
  out of rotation, re-routes its queued-but-unbound work to siblings,
  requests preemption (the engine checkpoints bound slots + pages and
  raises :class:`~repro_torch.core.task.ServicePreempted`), and
  immediately resumes it from that checkpoint — bound requests continue
  mid-generation, token for token as an undisturbed run.
* **pilot mode**: pass a :class:`~repro_torch.core.pilot.PilotManager`;
  each engine is placed on its **own pilot** via a
  :class:`~repro_torch.core.session.PlacementPolicy` (default
  :class:`~repro_torch.core.session.KindAwarePlacement`, i.e.
  ``PilotManager.place``) and submitted as a ``service=True`` task on a
  per-pilot :class:`~repro_torch.core.agent.RemoteAgent`.  When the agent
  preempts an engine for higher-priority work, the router's monitor
  notices the stalled service and re-routes its control inbox and
  engine queue to siblings; the checkpointed bound slots resume in
  place when the agent re-launches the service.

**Prefill/decode disaggregation**: engines constructed with
``prefill_only=True`` (role ``"prefill"``) run the ragged chunked
prefill and export each finished prompt as a
:class:`~repro_torch.serve.handoff.KVHandoff` — the request plus exactly
the page blocks its block-table row points at, on the host.  The router
harvests these and ships them to a decode engine **through the
Transport** (:meth:`~repro_torch.core.transport.Transport.submit`); the
decode engine writes the blocks into its own pool and rewrites a fresh
block-table row.  Bytes moved are bounded by the pages the migrating
request owns — never the pool.

**Resilience** (``policy=``): constructing the router with a
:class:`~repro_torch.core.resilience.policy.FailurePolicy` gives every
thread-mode member a
:class:`~repro_torch.core.resilience.policy.CircuitBreaker` and turns
engine crashes from terminal into recoverable.  A crash recovers the
engine's outstanding work (bound requests reset and re-enter as prompts;
queued entries and parked handoffs move back verbatim), re-routes it
through the rolling-restart requeue path, and restarts the engine with
fresh state; after ``eject_after`` consecutive faults the breaker opens
and the member receives no traffic until, ``probation_s`` later, a
single probe request is routed to it — the probe finishing DONE
re-admits the member (and records the crash→re-admission latency in
``stats()``), anything else re-ejects it.  Zero requests are lost or
duplicated across the cycle.
"""
from __future__ import annotations

import collections
import functools
import threading
import time
from typing import Any, Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.common.params import init_params
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core.agent import RemoteAgent
from repro_torch.core.pilot import PilotManager
from repro_torch.core.resilience.faults import InjectedFault
from repro_torch.core.resilience.policy import CircuitBreaker, FailurePolicy
from repro_torch.core.session import KindAwarePlacement, PlacementPolicy
from repro_torch.core.task import ServiceControl, ServicePreempted, TaskDescription, TaskState
from repro_torch.core.transport import InProcessTransport, Transport
from repro_torch.launch.mesh import resolve_device
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.handoff import KVHandoff, maybe_fail_delivery
from repro_torch.serve.request import Request, RequestState
from repro_torch.train.state import model_specs


def _ship_wire(hand: KVHandoff) -> KVHandoff:
    """Shipping body for remote transports (a transport with ``remote =
    True``): it runs in a worker process, so the handoff's page blocks
    cross the process boundary pickled on the way in and bitwise back
    out (``KVHandoff.__getstate__`` lowers them to numpy); the router
    binds the round-tripped pages to the client-held request.  The port's
    transports are in-process until its ``core/exec/`` lands (ROADMAP.md
    queue 1, item 6), so today only a test's stand-in remote transport
    takes this path."""
    return hand


class _Member:
    """One engine in the fleet: its control handle plus how it runs
    (thread mode or a service task on a per-pilot agent)."""

    def __init__(self, engine: ServeEngine, role: str,
                 breaker: Optional[CircuitBreaker] = None):
        self.engine = engine
        self.role = role  # "any" | "prefill" | "decode"
        self.control = ServiceControl()
        self.draining = False  # guarded-by router._cond (out of rotation)
        self.error: Optional[str] = None
        self.result: Optional[Dict[str, Any]] = None
        # resilience (router policy mode): the breaker gates traffic
        # after crashes; probe_req is the request whose completion
        # decides re-admission
        self.breaker = breaker
        self.probe_req: Optional[Request] = None  # guarded-by router._cond
        self.crashes = 0  # guarded-by router._cond
        self.crashed_at: Optional[float] = None  # guarded-by router._cond
        # thread mode
        self.thread: Optional[threading.Thread] = None
        self.paused = threading.Event()  # set while checkpointed (restart)
        self.resume = threading.Event()
        # pilot mode
        self.agent: Optional[RemoteAgent] = None
        self.pilot = None
        self.task = None

    def serving(self) -> bool:
        """True when the engine body is actually running (not preempted,
        not checkpoint-paused, not crashed)."""
        if self.error is not None:
            return False
        if self.thread is not None:
            return self.thread.is_alive() and not self.paused.is_set()
        if self.task is not None:
            return self.task.state is TaskState.RUNNING
        return False


class EngineRouter:
    """Shared-queue, load-aware front of a ServeEngine fleet."""

    def __init__(self, engines: Sequence[ServeEngine], *,
                 roles: Optional[Sequence[str]] = None,
                 transport: Optional[Transport] = None,
                 manager: Optional[PilotManager] = None,
                 placement: Optional[PlacementPolicy] = None,
                 num_devices: int = 1, group: Optional[str] = None,
                 priority: int = 0, poll_s: float = 0.002,
                 engine_queue_bound: Optional[int] = None,
                 policy: Optional[FailurePolicy] = None):
        if not engines:
            raise ValueError("need at least one engine")
        roles = list(roles) if roles is not None else [
            "prefill" if e.prefill_only else "any" for e in engines]
        if len(roles) != len(engines):
            raise ValueError("roles must parallel engines")
        for e, r in zip(engines, roles):
            if e.prefill_only != (r == "prefill"):
                raise ValueError(
                    f"engine {e.uid}: role {r!r} does not match "
                    f"prefill_only={e.prefill_only}")
        if any(r == "prefill" for r in roles) and not any(
                r in ("decode", "any") for r in roles):
            raise ValueError("prefill engines need a decode target")
        # a FailurePolicy turns engine crashes from terminal into
        # recoverable: each member gets a circuit breaker (thread mode —
        # pilot-mode restarts stay agent-driven through the task policy)
        self.policy = policy
        self.members = [
            _Member(e, r,
                    breaker=(CircuitBreaker(policy.eject_after,
                                            policy.probation_s)
                             if policy is not None else None))
            for e, r in zip(engines, roles)]
        self._own_transport = transport is None
        self._transport = (transport if transport is not None
                           else InProcessTransport(max_workers=2,
                                                   thread_name_prefix="rc-router"))
        self._manager = manager
        self._placement = placement or KindAwarePlacement()
        self._num_devices = num_devices
        self._group = group
        self._priority = priority
        self.poll_s = poll_s
        self._engine_queue_bound = engine_queue_bound
        # _cond guards the router's shared state: the queue, stats, and
        # lifecycle flags below (submitters, the route loop, and
        # rolling_restart callers all touch them)
        self._cond = threading.Condition()
        self.queue: Deque[Any] = collections.deque()  # guarded-by: _cond
        self._stats: Dict[str, Any] = collections.defaultdict(int)  # guarded-by: _cond
        self._requests: List[Request] = []  # guarded-by: _cond
        # crash -> re-admission latencies ({"engine", "recovery_s"})
        self._recoveries: List[Dict[str, Any]] = []  # guarded-by: _cond
        self._stop = False  # guarded-by: _cond
        self._started = False
        self._router_thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "EngineRouter":
        if self._started:
            return self
        self._started = True
        if self._manager is not None:
            self._start_pilot_mode()
        else:
            for m in self.members:
                m.thread = threading.Thread(
                    target=self._serve_loop, args=(m,),
                    name=f"rc-{m.engine.uid}", daemon=True)
                m.thread.start()
        self._router_thread = threading.Thread(
            target=self._route_loop, name="rc-router", daemon=True)
        self._router_thread.start()
        return self

    def _start_pilot_mode(self) -> None:
        from repro_torch.core.pipeline import Stage  # local: avoid import cycle
        used: List[Any] = []
        for m in self.members:
            stage = Stage(name=f"serve.{m.engine.uid}",
                          fn=m.engine.run_service, kind="inference",
                          num_devices=self._num_devices, service=True)
            pilots = [p for p in self._manager.pilots if p not in used]
            pilot = self._placement.place_stage(
                stage, manager=self._manager, pilots=pilots)
            if pilot is None:
                raise RuntimeError(
                    f"no free pilot for engine {m.engine.uid} "
                    f"({len(used)} already placed)")
            used.append(pilot)
            agent = RemoteAgent(pilot, max_workers=2)
            engine = m.engine

            def body(comm, *, control, resume_state=None, _e=engine):
                return _e.run_service(control, resume_state=resume_state)

            desc = TaskDescription(
                name=stage.name, fn=body, kind="inference",
                num_devices=self._num_devices, service=True,
                group=self._group, priority=self._priority)
            m.control = desc.control
            m.agent, m.pilot = agent, pilot
            [m.task] = agent.submit_async([desc])

    def _serve_loop(self, m: _Member) -> None:
        """Thread-mode engine body: run_service, pausing through the
        checkpoint/restore cycle on each rolling restart.

        With a router :class:`FailurePolicy` installed, a crash is
        *recoverable*: outstanding work is recovered
        (:meth:`ServeEngine.recover_outstanding`) and re-routed through
        the same requeue path a rolling restart uses, the member's
        circuit breaker counts the fault, and the engine restarts
        immediately with fresh state — the breaker, not the thread,
        decides when it sees traffic again (ejected members idle until
        a probationary probe re-admits them)."""
        state = None
        while True:
            try:
                m.result = m.engine.run_service(m.control, resume_state=state)
                return
            except ServicePreempted as e:
                state = e.state
                m.control._clear_preempt()
                m.paused.set()
                m.resume.wait()  # noqa: TMO001 — parked until restart; close() always sets resume
                m.resume.clear()
                m.paused.clear()
            except Exception as e:  # noqa: BLE001 — isolation boundary:
                # a crashed engine must release its waiters, not hang them
                if m.breaker is None:
                    m.error = f"{type(e).__name__}: {e}"
                    m.engine._fail_outstanding(
                        f"engine {m.engine.uid} crashed: {m.error}")
                    return
                recovered = (m.control.take_requests()
                             + m.engine.recover_outstanding())
                with self._cond:
                    m.crashes += 1
                    if m.crashed_at is None:
                        m.crashed_at = time.time()
                    m.probe_req = None  # a bound probe died with the state
                    self._stats["engine_crashes"] += 1
                    self._stats[f"crashes.{m.engine.uid}"] += 1
                    self._stats["requests_recovered"] += len(recovered)
                self._requeue(recovered)
                if m.breaker.record_fault():
                    with self._cond:
                        self._stats["ejections"] += 1
                state = None  # fresh slot state on restart

    def close(self, timeout: Optional[float] = 30.0) -> None:
        """Stop routing and the engines; unrouted requests FAIL (use
        ``drain`` first for a graceful shutdown)."""
        with self._cond:
            if self._stop:
                return
            self._stop = True
            unrouted, self.queue = list(self.queue), collections.deque()
            self._cond.notify_all()
        for entry in unrouted:
            req = entry.request if isinstance(entry, KVHandoff) else entry
            req._finish(RequestState.FAILED, "router stopped before routing")
        if self._router_thread is not None:
            self._router_thread.join(timeout)
        for m in self.members:
            m.control.stop()
            m.resume.set()  # unblock a checkpoint-paused thread
        for m in self.members:
            if m.thread is not None:
                m.thread.join(timeout)
            if m.agent is not None:
                m.agent.close(timeout=timeout)
        if self._own_transport:
            self._transport.shutdown(wait=True)

    def __enter__(self) -> "EngineRouter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- client side ---------------------------------------------------------

    def submit(self, request, **kw) -> Request:
        """Queue a request with the router (a :class:`Request` or a raw
        prompt array); it is routed to an engine as capacity allows."""
        if not isinstance(request, Request):
            request = Request(np.asarray(request, np.int32), **kw)
        with self._cond:
            if self._stop:
                raise RuntimeError("router is stopped")
            self.queue.append(request)
            self._requests.append(request)
            self._stats["submitted"] += 1
            self._cond.notify_all()
        return request

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Wait until every request submitted so far reached a terminal
        state; False on timeout.  The router keeps accepting new work —
        call :meth:`close` afterwards for shutdown."""
        deadline = None if timeout is None else time.time() + timeout
        with self._cond:
            reqs = list(self._requests)
        for r in reqs:
            left = (None if deadline is None
                    else max(0.0, deadline - time.time()))
            if not r.wait(left):
                return False
        with self._cond:  # prune: drained requests need no tracking
            self._requests = [q for q in self._requests if not q.done()]
        return True

    def rolling_restart(self, index: int, timeout: float = 60.0) -> None:
        """Restart one engine from checkpoint, mid-stream: take it out
        of rotation, re-route its queued-but-unbound work to siblings,
        checkpoint it through the preemption path (bound slots, pages,
        PRNG keys), and resume it from that checkpoint.  Bound requests
        continue exactly where they stopped."""
        m = self.members[index]
        if m.thread is None:
            raise RuntimeError(
                "rolling_restart drives the thread-mode preemption cycle; "
                "in pilot mode restarts are agent-driven")
        with self._cond:
            m.draining = True
        self._requeue(m.control.take_requests() + m.engine.steal_queued())
        m.control.request_preempt()
        if not m.paused.wait(timeout):
            with self._cond:
                m.draining = False
            raise TimeoutError(
                f"engine {m.engine.uid} did not checkpoint in {timeout}s")
        with self._cond:
            self._stats["restarts"] += 1
            m.draining = False
        m.resume.set()

    def stats(self) -> Dict[str, Any]:
        with self._cond:
            out: Dict[str, Any] = dict(self._stats)
            out["router_queue"] = len(self.queue)
            out["recoveries"] = [dict(r) for r in self._recoveries]
        out["engines"] = [m.engine.stats() for m in self.members]
        if self.policy is not None:
            out["breakers"] = {m.engine.uid: m.breaker.snapshot()
                               for m in self.members
                               if m.breaker is not None}
        for key in ("tokens_generated", "completed", "failed",
                    "handoffs_exported", "handoffs_imported"):
            out[f"fleet_{key}"] = sum(s.get(key, 0) for s in out["engines"])
        return out

    def admission_signals(self) -> List[Dict[str, Any]]:
        """Per-member routing view: the engine's own admission signals
        plus the router-side state that gates them (role, draining,
        serving, breaker snapshot, probe-in-flight)."""
        sigs: List[Dict[str, Any]] = []
        for m in self.members:
            sig = m.engine.admission_signals()
            with self._cond:
                sig["draining"] = m.draining
                sig["probe_inflight"] = m.probe_req is not None
                sig["crashes"] = m.crashes
            sig["role"] = m.role
            sig["serving"] = m.serving()
            sig["error"] = m.error
            if m.breaker is not None:
                sig["breaker"] = m.breaker.snapshot()
            sigs.append(sig)
        return sigs

    # -- routing core --------------------------------------------------------

    def _route_loop(self) -> None:
        while True:
            with self._cond:
                if self._stop:
                    return
            progressed = self._harvest_handoffs()
            progressed = self._pump() or progressed
            progressed = self._monitor() or progressed
            with self._cond:
                if self._stop:
                    return
                if not progressed:
                    # idle or backpressured (every engine saturated):
                    # wait for submissions/capacity instead of spinning
                    # on admission signals
                    self._cond.wait(self.poll_s)

    def _bound(self, m: _Member) -> int:
        """Max entries allowed to wait at one engine (its queue plus its
        control inbox) — small, so load stays in the router queue where
        it can still be steered."""
        return (self._engine_queue_bound if self._engine_queue_bound
                else max(2, m.engine.max_slots))

    def _candidates(self, entry) -> List[_Member]:
        want = "decode" if isinstance(entry, KVHandoff) else "prefill"
        with self._cond:
            live = [m for m in self.members
                    if not m.draining and m.error is None and m.serving()
                    and (m.breaker is None or m.breaker.state == "closed")]
        exact = [m for m in live if m.role == want]
        return exact or [m for m in live if m.role == "any"]

    def _pick_probe(self, entry) -> Optional[_Member]:
        """An ejected member due its probationary health check: route
        this entry to it as the probe.  ``breaker.admit()`` grants at
        most one probe per probation window, and the probe's terminal
        state (watched by :meth:`_monitor`) decides re-admission."""
        want = "decode" if isinstance(entry, KVHandoff) else "prefill"
        for m in self.members:
            if m.breaker is None or m.error is not None:
                continue
            if m.role not in (want, "any") or not m.serving():
                continue
            with self._cond:
                if m.draining or m.probe_req is not None:
                    continue
            if m.breaker.state != "closed" and m.breaker.admit():
                return m
        return None

    def _pick(self, entry) -> Optional[_Member]:
        """Best engine for this entry by admission signals, or None when
        every candidate is at its backlog bound (backpressure)."""
        best, best_score = None, None
        for m in self._candidates(entry):
            sig = m.engine.admission_signals()
            backlog = sig["queue_depth"] + m.control.pending_requests()
            if backlog >= self._bound(m):
                continue
            score = (sig["max_slots"] - sig["occupied"] - backlog,
                     sig["free_pages"] / max(sig["num_pages"], 1),
                     -sig["oldest_queued_age_s"])
            if best_score is None or score > best_score:
                best, best_score = m, score
        return best

    def _pump(self) -> bool:
        """Route as much of the shared queue as current capacity admits;
        what does not fit stays queued, in order."""
        with self._cond:
            pending, self.queue = list(self.queue), collections.deque()
        kept: List[Any] = []
        routed = 0
        for entry in pending:
            probe_m = self._pick_probe(entry)
            m = probe_m if probe_m is not None else self._pick(entry)
            if m is None:
                kept.append(entry)
                continue
            if probe_m is not None:
                req = entry.request if isinstance(entry, KVHandoff) else entry
                with self._cond:
                    m.probe_req = req
                    self._stats["probes_routed"] += 1
            if isinstance(entry, KVHandoff):
                # the page blocks cross engines through the transport —
                # the data plane a cross-node fabric will replace
                if getattr(self._transport, "remote", False):
                    # subprocess transport: the pages are pickled into a
                    # worker process and back (a real process-boundary
                    # crossing), then bound parent-side in on_done — a
                    # bound method cannot cross the pickle boundary
                    self._transport.submit(
                        _ship_wire, entry,
                        on_done=functools.partial(self._deliver_shipped,
                                                  hand=entry, m=m))
                else:
                    self._transport.submit(self._deliver, entry, m)
                routed += 1
                continue
            try:
                m.control.submit_request(entry)
            except RuntimeError:
                if probe_m is not None:
                    self._probe_failed(m)
                kept.append(entry)  # raced a drain/stop: hold and re-pick
                continue
            routed += 1
            with self._cond:
                self._stats["routed"] += 1
                self._stats[f"routed_to.{m.engine.uid}"] += 1
        if kept:
            with self._cond:
                # new arrivals landed behind these in wall-clock order
                self.queue = collections.deque(kept + list(self.queue))
        return routed > 0

    def _deliver_shipped(self, fut, hand: KVHandoff, m: _Member) -> None:
        """Remote-transport delivery: bind the wire-round-tripped handoff
        (whose page bytes crossed the process boundary) to the
        client-held Request and deliver it.  A worker crash mid-ship
        loses nothing — the original handoff is still parent-side and is
        simply re-queued for another route."""
        try:
            shipped = fut.result()  # noqa: TMO001 — done-callback: result is ready
        except Exception:  # noqa: BLE001 — WorkerCrashed/RemoteTaskError
            self._requeue([hand])
            return
        # the request replica that rode the wire is discarded: the
        # client streams from the object it holds
        shipped.request = hand.request
        with self._cond:
            self._stats["handoff_wire_roundtrips"] += 1
        self._deliver(shipped, m)

    def _deliver(self, hand: KVHandoff, m: _Member) -> None:
        """Transport-side delivery of one migrated prefill.  Both an
        injected delivery failure (``FaultPlan.fail_handoff``) and a
        drain race leave the handoff intact parent-side — it is
        re-queued for another route, never lost."""
        try:
            maybe_fail_delivery(hand)
            m.control.submit_request(hand)
        except (InjectedFault, RuntimeError) as e:
            injected = isinstance(e, InjectedFault)
            was_probe = False
            with self._cond:
                if injected:
                    self._stats["handoff_faults"] += 1
                if m.probe_req is hand.request:
                    m.probe_req = None
                    was_probe = True
                    self._stats["probes_failed"] += 1
            if m.breaker is not None and (injected or was_probe):
                m.breaker.record_fault()
            self._requeue([hand])
            return
        with self._cond:
            self._stats["handoffs_routed"] += 1
            self._stats["handoff_bytes"] += hand.kv_bytes
            self._stats["handoff_pages"] += hand.n_pages

    def _probe_failed(self, m: _Member) -> None:
        """A probe could not run or came back FAILED: re-eject (the
        breaker reopens and restarts its probation window)."""
        with self._cond:
            m.probe_req = None
            self._stats["probes_failed"] += 1
        m.breaker.record_fault()

    def _harvest_handoffs(self) -> bool:
        """Collect exported prefills into the shared queue (they route
        to decode engines like any other entry, but ship via the
        transport)."""
        got = False
        for m in self.members:
            if not m.engine.prefill_only:
                continue
            hands = m.engine.take_handoffs()
            if hands:
                with self._cond:
                    self.queue.extend(hands)
                    self._cond.notify_all()
                got = True
        return got

    def _monitor(self) -> bool:
        """Re-route work stranded at an engine that is not serving
        (preempted by its agent, or checkpoint-paused): its control
        inbox and unbound engine queue move back to the shared queue.
        Bound slots ride the engine's checkpoint and resume in place."""
        moved = False
        for m in self.members:
            if m.serving() or m.error is not None:
                continue
            if m.thread is not None and not m.paused.is_set():
                continue  # thread mode: only a checkpoint pause stalls
            stolen = m.control.take_requests() + m.engine.steal_queued()
            if stolen:
                self._requeue(stolen)
                with self._cond:
                    self._stats["rerouted"] += len(stolen)
                moved = True
        moved = self._resolve_probes() or moved
        return moved

    def _resolve_probes(self) -> bool:
        """Settle finished probationary probes: DONE re-admits the
        member (breaker closes, recovery latency recorded), FAILED
        re-ejects it for another probation round."""
        resolved = False
        for m in self.members:
            with self._cond:
                pr = m.probe_req
            if pr is None or not pr.done():
                continue
            resolved = True
            if pr.state is RequestState.DONE:
                m.breaker.record_success()
                with self._cond:
                    m.probe_req = None
                    self._stats["readmissions"] += 1
                    if m.crashed_at is not None:
                        self._recoveries.append({
                            "engine": m.engine.uid,
                            "recovery_s": time.time() - m.crashed_at,
                        })
                        m.crashed_at = None
            else:
                self._probe_failed(m)
        return resolved

    def _requeue(self, entries: List[Any]) -> None:
        if not entries:
            return
        with self._cond:
            self.queue.extend(entries)
            self._cond.notify_all()


def build_fleet(cfg: ModelConfig, run_cfg: Optional[RunConfig] = None, *,
                num_engines: int, disaggregate: bool = False,
                num_prefill: Optional[int] = None, params: Any = None,
                seed: int = 0, name_prefix: str = "fleet",
                router_kwargs: Optional[Dict[str, Any]] = None,
                prefill_overrides: Optional[Dict[str, Any]] = None,
                device=None, **engine_kwargs) -> EngineRouter:
    """Construct N engines on ``device`` (the card unless the caller asks
    for the CPU) sharing one parameter set (``params``, or drawn from
    ``seed`` by the port's init) and wrap them in a router.
    ``disaggregate=True`` splits roles: ``num_prefill`` (default N//2,
    floored at 1) prefill-only engines feed the rest via KV handoff.

    Prefill engines default to WHOLE-PROMPT prefill
    (``prefill_chunk_tokens=None``): chunking exists to bound the decode
    stalls a long admission inflicts on in-flight tails, and a
    prefill-specialised engine has no decode tails to protect — capping
    its per-step prompt budget would only throttle the fleet's prefill
    capacity (and TTFT) for nothing.  ``prefill_overrides`` replaces the
    per-role kwarg overlay for prefill engines."""
    if num_engines < 1:
        raise ValueError("need num_engines >= 1")
    dev = resolve_device(device)
    if params is None:
        params = init_params(torch.Generator(device=dev).manual_seed(seed),
                             model_specs(cfg), dev)
    engine_kwargs["device"] = dev
    engines: List[ServeEngine] = []
    if disaggregate:
        if num_engines < 2:
            raise ValueError("disaggregation needs >= 2 engines")
        np_ = (num_prefill if num_prefill is not None
               else max(1, num_engines // 2))
        if not 0 < np_ < num_engines:
            raise ValueError(f"num_prefill={np_} must leave >= 1 decode "
                             f"engine out of {num_engines}")
        pre_kw = dict(engine_kwargs)
        pre_kw.update({"prefill_chunk_tokens": None}
                      if prefill_overrides is None else prefill_overrides)
        for i in range(num_engines):
            pre = i < np_
            engines.append(ServeEngine(
                cfg, run_cfg, params=params, prefill_only=pre,
                name=f"{name_prefix}.{'pre' if pre else 'dec'}{i}",
                **(pre_kw if pre else engine_kwargs)))
        roles = ["prefill" if i < np_ else "decode"
                 for i in range(num_engines)]
    else:
        for i in range(num_engines):
            engines.append(ServeEngine(
                cfg, run_cfg, params=params,
                name=f"{name_prefix}.eng{i}", **engine_kwargs))
        roles = ["any"] * num_engines
    return EngineRouter(engines, roles=roles, **(router_kwargs or {}))
