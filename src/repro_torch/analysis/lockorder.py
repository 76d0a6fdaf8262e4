"""Runtime lock-order recorder, enabled under tests (mirror of
``repro.analysis.lockorder``).

Wraps ``threading.Lock``/``threading.Condition`` instances in recording
proxies.  Every acquisition while other recorded locks are held adds a
directed edge ``held -> acquiring``; a cycle in that graph is a
lock-order inversion — two threads that interleave the other way
deadlock.  Recording is cheap enough for tests but is NOT installed in
production paths: tests call :func:`instrument` (or
:func:`instrument_runtime`) on the objects they drive.

The proxy forwards the full Condition protocol (``wait`` / ``wait_for``
/ ``notify`` / ``notify_all``); ``wait`` blocks the thread, so the held
set needs no adjustment across the internal release/reacquire.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Set, Tuple


class LockOrderRecorder:
    def __init__(self) -> None:
        self._meta = threading.Lock()
        self._edges: Dict[str, Set[str]] = {}
        self._sites: Dict[Tuple[str, str], str] = {}
        self._tls = threading.local()

    # -- proxy callbacks -------------------------------------------------
    def _held(self) -> List[str]:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    def on_acquired(self, name: str) -> None:
        held = self._held()
        with self._meta:
            for h in held:
                if h != name:
                    self._edges.setdefault(h, set()).add(name)
        held.append(name)

    def on_released(self, name: str) -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i] == name:
                del held[i]
                break

    # -- instrumentation -------------------------------------------------
    def wrap(self, lock, name: str) -> "_RecordingLock":
        return _RecordingLock(lock, name, self)

    def instrument(self, obj, attr: str, name: Optional[str] = None) -> None:
        """Swap ``obj.<attr>`` (a Lock or Condition) for a recording proxy."""
        setattr(obj, attr, self.wrap(getattr(obj, attr),
                                     name or f"{type(obj).__name__}.{attr}"))

    # -- queries ---------------------------------------------------------
    def edges(self) -> Dict[str, Set[str]]:
        with self._meta:
            return {k: set(v) for k, v in self._edges.items()}

    def cycles(self) -> List[List[str]]:
        """All elementary cycles reachable in the order graph (DFS)."""
        edges = self.edges()
        cycles: List[List[str]] = []
        seen_keys: Set[Tuple[str, ...]] = set()

        def dfs(node: str, path: List[str], on_path: Set[str]) -> None:
            for nxt in sorted(edges.get(node, ())):
                if nxt in on_path:
                    cyc = path[path.index(nxt):] + [nxt]
                    # canonicalise by rotating to the smallest element
                    body = cyc[:-1]
                    i = body.index(min(body))
                    key = tuple(body[i:] + body[:i])
                    if key not in seen_keys:
                        seen_keys.add(key)
                        cycles.append(list(key) + [key[0]])
                elif nxt not in path:
                    dfs(nxt, path + [nxt], on_path | {nxt})

        for start in sorted(edges):
            dfs(start, [start], {start})
        return cycles

    def assert_no_cycles(self) -> None:
        cycles = self.cycles()
        if cycles:
            pretty = "; ".join(" -> ".join(c) for c in cycles)
            raise AssertionError(f"lock-order cycle(s) recorded: {pretty}")


class _RecordingLock:
    """Proxy over a Lock or Condition that reports to a recorder."""

    def __init__(self, inner, name: str, recorder: LockOrderRecorder) -> None:
        self._inner = inner
        self._name = name
        self._recorder = recorder

    def acquire(self, *args, **kwargs):
        got = self._inner.acquire(*args, **kwargs)
        if got:
            self._recorder.on_acquired(self._name)
        return got

    def release(self) -> None:
        self._inner.release()
        self._recorder.on_released(self._name)

    def __enter__(self):
        self._inner.__enter__()
        self._recorder.on_acquired(self._name)
        return self

    def __exit__(self, *exc) -> bool:
        self._recorder.on_released(self._name)
        return bool(self._inner.__exit__(*exc))

    # Condition protocol — the underlying wait() releases and reacquires
    # the inner lock while this thread is blocked, so the recorded held
    # set is accurate again by the time wait() returns.
    def wait(self, timeout: Optional[float] = None):
        return self._inner.wait(timeout)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        return self._inner.wait_for(predicate, timeout)

    def notify(self, n: int = 1) -> None:
        self._inner.notify(n)

    def notify_all(self) -> None:
        self._inner.notify_all()

    def locked(self) -> bool:
        return self._inner.locked()

    def __repr__(self) -> str:
        return f"<recorded {self._name} {self._inner!r}>"


def instrument_runtime(recorder: LockOrderRecorder, *, agent=None,
                       pipeline=None, manager=None, session=None,
                       engine=None, transport=None) -> None:
    """Instrument the runtime's lock sites across the agent <-> pipeline
    <-> pilot boundary (and optionally session, engine and a
    ``core.exec.SubprocessTransport``: its scheduling condition and its
    stream table's lock)."""
    if agent is not None:
        recorder.instrument(agent, "_cond", "agent._cond")
        recorder.instrument(agent, "_result_lock", "agent._result_lock")
    if pipeline is not None:
        recorder.instrument(pipeline, "_lock", "pipeline._lock")
    if manager is not None:
        recorder.instrument(manager, "_lock", "manager._lock")
        for pilot in getattr(manager, "pilots", []):
            recorder.instrument(pilot, "_lock", f"pilot[{pilot.uid}]._lock")
    if session is not None:
        recorder.instrument(session, "_lock", "session._lock")
    if engine is not None:
        recorder.instrument(engine, "_lock", "engine._lock")
    if transport is not None:
        recorder.instrument(transport, "_cond", "transport._cond")
        recorder.instrument(transport._streams, "_lock", "transport._streams._lock")
