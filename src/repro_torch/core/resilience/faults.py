"""Deterministic fault injection: seeded plans, logical event traces
(mirror of ``repro.core.resilience.faults``).

Chaos testing a runtime with ``kill -9`` at "about the right moment" is
how flaky CI is made: the interesting failure windows (mid-dispatch,
mid-checkpoint-rename, mid-KV-handoff) are microseconds wide and move
with machine load.  This module replaces wall-clock racing with
*logical* triggers: a ``FaultPlan`` is a list of ``FaultSpec``s, each
naming an **injection site** (a stable string the runtime consults at
the exact vulnerable point), a **match** on the event's coordinates
(worker id, engine uid, checkpoint step), and an **nth** occurrence
counter.  The Nth matching event at that site fires the fault — every
run of the same plan over the same workload fires at the same logical
point, so the recorded event ``trace()`` is reproducible from the seed
and plan alone.

Sites of the port:

==================== ====================================================
``checkpoint.save``     a checkpoint step finished its atomic rename
                        (``repro_torch.checkpoint.store``) — action
                        ``tear`` truncates a leaf (or the manifest) at
                        byte offset ``at_byte``, the post-crash torn state
                        fsync exists to prevent
``handoff.deliver``     a KV-page handoff is being delivered to a decode
                        engine (``serve.handoff.maybe_fail_delivery``) —
                        action ``fail`` aborts the delivery
``engine.step``         a ServeEngine with work is about to step — action
                        ``crash`` raises :class:`InjectedFault`
``transport.dispatch``  the subprocess transport handed a worker its task
                        (``core/exec/transport.py``) — ``crash_worker``
                        kills the worker mid-task, ``stall_heartbeat``
                        silences its heartbeats for ``for_s`` seconds
``protocol.recv``       a frame arrived on a worker channel
                        (``core/exec/protocol.py`` ``Channel.fault_filter``)
                        — ``drop`` swallows it, ``delay`` holds it
==================== ====================================================

Hooks are module-global (``set_fault_injector`` / ``active()``) so the
runtime pays one ``is None`` check per site when chaos is off.  Plans
serialize to JSON (``to_json``/``from_json``) so a parent process can arm
faults in another process through the environment (``REPRO_FAULT_PLAN``,
``install_from_env``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import threading
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "InjectedFault", "FaultSpec", "FaultPlan", "FaultInjector",
    "set_fault_injector", "active", "inject", "install_from_env",
    "PLAN_ENV",
]

#: env var carrying a JSON FaultPlan into subprocess workers
PLAN_ENV = "REPRO_FAULT_PLAN"


class InjectedFault(RuntimeError):
    """Raised (or delivered) by a fired fault — always deliberate."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One planned fault: fire ``action`` at the ``nth`` event at
    ``site`` whose coordinates equal every entry of ``match``."""

    site: str
    action: str
    nth: int = 1
    match: Tuple[Tuple[str, Any], ...] = ()
    params: Tuple[Tuple[str, Any], ...] = ()

    @classmethod
    def make(cls, site: str, action: str, nth: int = 1,
             match: Optional[Dict[str, Any]] = None,
             params: Optional[Dict[str, Any]] = None) -> "FaultSpec":
        return cls(site=site, action=action, nth=max(1, int(nth)),
                   match=tuple(sorted((match or {}).items())),
                   params=tuple(sorted((params or {}).items())))


class FaultPlan:
    """Builder for a seeded, declarative fault schedule."""

    def __init__(self, seed: int = 0,
                 specs: Optional[List[FaultSpec]] = None):
        self.seed = int(seed)
        self.specs: List[FaultSpec] = list(specs or [])

    # -- declarative builders (chainable) ----------------------------------
    def _add(self, site, action, nth=1, match=None, params=None):
        self.specs.append(FaultSpec.make(site, action, nth, match, params))
        return self

    def crash_worker(self, worker: Optional[int] = None,
                     at_task: int = 1) -> "FaultPlan":
        """Kill worker ``worker`` (any, if None) right after it is handed
        its ``at_task``-th matching task — the worker exits mid-task."""
        m = {} if worker is None else {"worker": worker}
        return self._add("transport.dispatch", "crash_worker",
                         nth=at_task, match=m)

    def stall_heartbeat(self, for_s: float, worker: Optional[int] = None,
                        at_task: int = 1) -> "FaultPlan":
        """Suppress a worker's heartbeats for ``for_s`` seconds starting
        at its ``at_task``-th dispatch (task keeps running)."""
        m = {} if worker is None else {"worker": worker}
        return self._add("transport.dispatch", "stall_heartbeat",
                         nth=at_task, match=m, params={"for_s": for_s})

    def drop_reply(self, nth: int = 1,
                   worker: Optional[int] = None) -> "FaultPlan":
        """Swallow the ``nth`` task-result frame on the parent channel."""
        m = {"mtype": "result"}
        if worker is not None:
            m["worker"] = worker
        return self._add("protocol.recv", "drop", nth=nth, match=m)

    def delay_reply(self, for_s: float, nth: int = 1) -> "FaultPlan":
        """Hold the ``nth`` task-result frame for ``for_s`` seconds."""
        return self._add("protocol.recv", "delay", nth=nth,
                         match={"mtype": "result"},
                         params={"for_s": for_s})

    def tear_checkpoint(self, at_byte: int, step: Optional[int] = None,
                        leaf: int = 0, nth: int = 1) -> "FaultPlan":
        """Truncate leaf file ``leaf`` (or the manifest if ``leaf < 0``)
        of checkpoint ``step`` at ``at_byte`` right after the rename —
        the on-disk state a crash between rename and data sync leaves."""
        m = {} if step is None else {"step": step}
        return self._add("checkpoint.save", "tear", nth=nth, match=m,
                         params={"at_byte": at_byte, "leaf": leaf})

    def fail_handoff(self, nth: int = 1) -> "FaultPlan":
        """Abort the ``nth`` KV-page handoff delivery."""
        return self._add("handoff.deliver", "fail", nth=nth)

    def crash_engine(self, engine: Optional[str] = None,
                     at_step: int = 1) -> "FaultPlan":
        """Raise InjectedFault out of the engine's ``at_step``-th step."""
        m = {} if engine is None else {"engine": engine}
        return self._add("engine.step", "crash", nth=at_step, match=m)

    # -- serialization (env-var propagation into workers) ------------------
    def to_json(self) -> str:
        return json.dumps({
            "seed": self.seed,
            "specs": [{"site": s.site, "action": s.action, "nth": s.nth,
                       "match": dict(s.match), "params": dict(s.params)}
                      for s in self.specs],
        }, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        raw = json.loads(text)
        return cls(seed=raw.get("seed", 0),
                   specs=[FaultSpec.make(s["site"], s["action"],
                                         s.get("nth", 1), s.get("match"),
                                         s.get("params"))
                          for s in raw.get("specs", [])])

    def injector(self) -> "FaultInjector":
        return FaultInjector(self)


class FaultInjector:
    """Counts site events against a plan and fires each spec once.

    ``fire(site, **coords)`` is the single runtime entry point: it bumps
    the per-spec counter of every spec whose site and match agree with
    the event and, when a counter reaches its ``nth``, returns the
    action record ``{"action": ..., **params}`` (one spec per event —
    first match wins).  Every fired fault is appended to the logical
    event trace; ``trace()`` contains ordinals and coordinates only (no
    wall-clock times), so identical plans over identical workloads
    produce identical traces.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._lock = threading.Lock()
        # guarded-by: _lock
        self._counts = [0] * len(plan.specs)
        self._fired = [False] * len(plan.specs)
        self._events: List[Tuple[int, str, str, Tuple[Tuple[str, Any], ...]]]
        self._events = []

    def fire(self, site: str, **coords) -> Optional[Dict[str, Any]]:
        with self._lock:
            for i, spec in enumerate(self.plan.specs):
                if spec.site != site:
                    continue
                if any(coords.get(k) != v for k, v in spec.match):
                    continue
                self._counts[i] += 1
                if not self._fired[i] and self._counts[i] >= spec.nth:
                    self._fired[i] = True
                    self._events.append((
                        len(self._events), site, spec.action,
                        tuple(sorted(coords.items())),
                    ))
                    return {"action": spec.action, **dict(spec.params)}
        return None

    def trace(self) -> List[Tuple]:
        """Logical fault trace: [(ordinal, site, action, coords), ...]."""
        with self._lock:
            return list(self._events)

    def all_fired(self) -> bool:
        with self._lock:
            return all(self._fired)

    def pending(self) -> List[FaultSpec]:
        """Specs that have not fired yet (useful for bench assertions)."""
        with self._lock:
            return [s for s, f in zip(self.plan.specs, self._fired)
                    if not f]


# -- process-global hook ---------------------------------------------------
_active: Optional[FaultInjector] = None


def set_fault_injector(inj: Optional[FaultInjector]) -> None:
    """Install (or clear, with None) the process-wide injector."""
    global _active
    _active = inj


def active() -> Optional[FaultInjector]:
    """The installed injector, or None — sites check this per event."""
    return _active


@contextlib.contextmanager
def inject(plan: FaultPlan):
    """Context manager: arm ``plan`` for the block, yield its injector."""
    inj = plan.injector()
    set_fault_injector(inj)
    try:
        yield inj
    finally:
        set_fault_injector(None)


def install_from_env(environ=os.environ) -> Optional[FaultInjector]:
    """Arm the injector from ``REPRO_FAULT_PLAN`` if set (worker-side)."""
    text = environ.get(PLAN_ENV)
    if not text:
        return None
    inj = FaultPlan.from_json(text).injector()
    set_fault_injector(inj)
    return inj
