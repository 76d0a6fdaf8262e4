"""Unified failure policy: retry budgets, backoff, deadlines, breakers
(mirror of ``repro.core.resilience.policy``).

Every layer that meets a fault asks the same question — retry, when,
and until when — and ``FailurePolicy`` is the one answer they consult
(the agent's retry loop, the fleet router's breakers and the subprocess
transport's worker respawn):

* **retry budget** — how many attempts a unit of work gets;
* **exponential backoff + deterministic jitter** — how long to wait
  between attempts (jitter is a pure function of ``(seed, key,
  attempt)`` so a replayed schedule is bit-identical — no
  ``random.random()`` flakes in tests);
* **per-attempt timeout** — how long a single attempt may run before
  the runtime declares it hung (the subprocess transport's monitor
  enforces it; the in-process transport has no monitor);
* **end-to-end deadline** — how long the whole unit of work may take
  across all attempts before it fails *cleanly* (devices released,
  quotas balanced) instead of retrying forever.

``CircuitBreaker`` layers fleet semantics on top: after
``eject_after`` consecutive faults a member is ejected (``open``), sits
out a probationary window, then a single probe request decides whether
it is re-admitted (``half_open`` → ``closed``) or re-ejected.
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from typing import Optional

__all__ = ["FailurePolicy", "CircuitBreaker"]


def _unit_hash(*parts) -> float:
    """Deterministic float in [0, 1) from the given parts."""
    h = hashlib.sha256("|".join(str(p) for p in parts).encode()).digest()
    return int.from_bytes(h[:8], "big") / 2 ** 64


@dataclasses.dataclass(frozen=True)
class FailurePolicy:
    """How a unit of work (task attempt, worker respawn, engine) retries.

    The default mirrors the legacy ``TaskDescription.max_retries = 2``
    behaviour with zero backoff, so installing a policy nowhere changes
    scheduling until a caller opts into backoff/deadlines.
    """

    #: retry budget: total attempts allowed = max_retries + 1
    max_retries: int = 2
    #: first backoff delay; 0 disables backoff entirely
    backoff_base_s: float = 0.0
    #: multiplier applied per further attempt
    backoff_factor: float = 2.0
    #: ceiling on any single backoff delay
    backoff_max_s: float = 30.0
    #: extra delay as a fraction of the backoff, in [0, jitter)
    jitter: float = 0.1
    #: how long one attempt may run before it is declared hung
    attempt_timeout_s: Optional[float] = None
    #: wall-clock budget for the whole unit of work across attempts
    deadline_s: Optional[float] = None
    #: fleet routing: consecutive faults before an engine is ejected
    #: (its CircuitBreaker opens and traffic re-routes to siblings)
    eject_after: int = 3
    #: fleet routing: seconds an ejected engine sits out before a
    #: single probe request decides its re-admission
    probation_s: float = 1.0
    #: seeds the deterministic jitter
    seed: int = 0

    def allow_retry(self, attempts: int) -> bool:
        """True if another attempt fits the budget (attempts so far)."""
        return attempts <= self.max_retries

    def backoff_s(self, attempt: int, key: str = "") -> float:
        """Delay before attempt ``attempt + 1`` (attempt counts from 1).

        Deterministic: the jitter term is a hash of ``(seed, key,
        attempt)``, so the same schedule replays identically while
        distinct keys (task uids, worker ids) still decorrelate.
        """
        if self.backoff_base_s <= 0:
            return 0.0
        base = self.backoff_base_s * self.backoff_factor ** max(0, attempt - 1)
        base = min(base, self.backoff_max_s)
        if self.jitter > 0:
            base *= 1.0 + self.jitter * _unit_hash(self.seed, key, attempt)
        return min(base, self.backoff_max_s * (1.0 + self.jitter))

    def deadline_at(self, start: float) -> Optional[float]:
        """Absolute deadline for work that started at ``start``."""
        if self.deadline_s is None:
            return None
        return start + self.deadline_s

    @classmethod
    def from_retries(cls, max_retries: int) -> "FailurePolicy":
        """Legacy adapter: bare retry counter, no backoff, no deadline."""
        return cls(max_retries=max_retries)


class CircuitBreaker:
    """Consecutive-fault ejection with probationary re-admission.

    States: ``closed`` (healthy) → ``open`` (ejected after
    ``eject_after`` consecutive faults; sits out ``probation_s``) →
    ``half_open`` (one probe admitted) → ``closed`` on probe success or
    back to ``open`` on probe failure.  Thread-safe; every transition
    is appended to ``transitions`` for tests and stats.
    """

    def __init__(self, eject_after: int = 3, probation_s: float = 1.0,
                 clock=time.monotonic):
        self.eject_after = max(1, int(eject_after))
        self.probation_s = float(probation_s)
        self._clock = clock
        self._lock = threading.Lock()
        # guarded-by: _lock
        self._state = "closed"
        self._faults = 0          # consecutive faults while closed
        self._opened_at = 0.0
        self._probe_inflight = False
        self.transitions = []     # [(state, at)] — appended under _lock

    # -- state transitions -------------------------------------------------
    def _set_locked(self, state: str) -> None:
        if state != self._state:
            self._state = state
            self.transitions.append((state, self._clock()))

    def record_fault(self) -> bool:
        """Count one fault.  Returns True if this fault ejected (opened)."""
        with self._lock:
            if self._state == "half_open":
                # probe failed: back to open, restart probation
                self._probe_inflight = False
                self._opened_at = self._clock()
                self._set_locked("open")
                return True
            self._faults += 1
            if self._state == "closed" and self._faults >= self.eject_after:
                self._opened_at = self._clock()
                self._set_locked("open")
                return True
            return False

    def record_success(self) -> None:
        """Count one success: closes a half-open probe, clears the streak."""
        with self._lock:
            self._faults = 0
            if self._state == "half_open":
                self._probe_inflight = False
                self._set_locked("closed")

    # -- admission ---------------------------------------------------------
    def admit(self) -> bool:
        """May this member take a request right now?

        ``closed`` → yes.  ``open`` → no until probation elapses, at
        which point the breaker moves to ``half_open`` and admits
        exactly one probe; further calls return False until the probe
        resolves via record_success/record_fault.
        """
        with self._lock:
            if self._state == "closed":
                return True
            if self._state == "open":
                if self._clock() - self._opened_at >= self.probation_s:
                    self._set_locked("half_open")
                    self._probe_inflight = True
                    return True
                return False
            # half_open: only the single in-flight probe
            if not self._probe_inflight:
                self._probe_inflight = True
                return True
            return False

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "state": self._state,
                "consecutive_faults": self._faults,
                "probe_inflight": self._probe_inflight,
                "transitions": list(self.transitions),
            }
