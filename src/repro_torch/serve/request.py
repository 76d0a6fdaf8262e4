"""Serving requests: what a client submits to the ServeEngine.

A request is a prompt plus generation limits; the engine fills in the
lifecycle (QUEUED -> RUNNING -> DONE/FAILED), the generated tokens, and
the latency timestamps the serving benchmark reports (time-to-first-token
and end-to-end latency).
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
import threading
import time
from typing import List, Optional

import numpy as np


class RequestState(enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"   # occupying a slot
    DONE = "done"
    FAILED = "failed"


_rid = itertools.count()


@dataclasses.dataclass
class Request:
    """One generation request.

    ``prompt`` is a 1-D int32 token array; generation stops at
    ``max_new_tokens``, on ``stop_token``, or when the slot's KV cache is
    full — whichever comes first.  Sampling is greedy by default
    (``temperature=0``); ``temperature > 0`` samples from the
    temperature-scaled distribution, optionally top-k filtered, from a
    per-request stream seeded by ``seed`` (reproducible across engine
    preemption/resume — the engine checkpoints the slot's PRNG key).
    """

    prompt: np.ndarray
    max_new_tokens: int = 16
    stop_token: Optional[int] = None
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0
    rid: str = dataclasses.field(
        default_factory=lambda: f"req.{next(_rid):06d}")
    state: RequestState = RequestState.QUEUED
    tokens: List[int] = dataclasses.field(default_factory=list)  # generated
    error: Optional[str] = None
    # lifecycle timestamps (benchmark latency decomposition)
    submitted_at: float = dataclasses.field(default_factory=time.time)
    admitted_at: Optional[float] = None
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    # per-token emission times (parallel to ``tokens``) — the serving
    # benchmark's inter-token latency distribution reads the diffs
    token_times: List[float] = dataclasses.field(default_factory=list)
    _finished: threading.Event = dataclasses.field(
        default_factory=threading.Event, repr=False, compare=False)

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise ValueError("empty prompt")

    # Requests cross process boundaries (subprocess transport: service
    # inbox forwarding, engine checkpoints inside ServicePreempted state,
    # KV handoffs).  threading.Event is not picklable, so it travels as
    # its set-ness and is rebuilt on the far side.
    def __getstate__(self):
        state = dict(self.__dict__)
        state["_finished"] = self._finished.is_set()
        return state

    def __setstate__(self, state):
        was_set = state.pop("_finished", False)
        self.__dict__.update(state)
        ev = threading.Event()
        if was_set:
            ev.set()
        self._finished = ev

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def ttft_s(self) -> Optional[float]:
        """Time to first token (queueing + prefill)."""
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.submitted_at

    @property
    def inter_token_s(self) -> List[float]:
        """Gaps between consecutive emitted tokens.  Decode stalls caused
        by other requests' prefills land here — the quantity chunked
        prefill bounds."""
        return [b - a for a, b in
                zip(self.token_times, self.token_times[1:])]

    @property
    def latency_s(self) -> Optional[float]:
        if self.finished_at is None:
            return None
        return self.finished_at - self.submitted_at

    def done(self) -> bool:
        return self.state in (RequestState.DONE, RequestState.FAILED)

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the request reaches a terminal state."""
        return self._finished.wait(timeout)

    def reset_for_retry(self) -> None:
        """Return a non-terminal request to QUEUED so a router can
        re-route it after an engine crash destroyed its in-pool KV.
        Generated tokens are discarded and regenerated from the prompt
        on the new engine — greedy decoding (the default) regenerates
        them bit-identically, and seeded sampling restarts its
        per-request stream from ``seed``, so the retried output is
        reproducible either way.  Must not be called on a finished
        request (its waiters have already been released)."""
        if self.done():
            raise RuntimeError(f"cannot reset finished request {self.rid}")
        self.state = RequestState.QUEUED
        self.tokens = []
        self.token_times = []
        self.error = None
        self.admitted_at = None
        self.first_token_at = None
        self.finished_at = None

    def _finish(self, state: RequestState, error: Optional[str] = None) -> None:
        self.state = state
        self.error = error
        self.finished_at = time.time()
        self._finished.set()
