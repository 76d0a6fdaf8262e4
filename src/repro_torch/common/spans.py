"""Spans of the port's host loops: what the program was doing, and when,
on the clock of a device trace.

Tracing is off until :func:`enable`.  While it is off, :func:`span` and
:func:`wait` return the one shared :data:`OFF` object after a single
check of the module's ``on``, so the serving step and the dataframe
operators pay nothing for their spans; a call site whose attributes cost
something to build builds them only under ``if spans.on:``.

While it is on, each span records its ``name``, the ``index`` of its
parent (the innermost span open on the same thread when it opened, or
None), its ``thread``, ``t0_ns`` and ``t1_ns`` from ``time.time_ns()`` (the
clock ``torch.profiler`` converts its device timestamps to), ``wait``
(True for a :func:`wait` span: the host blocks on the card there) and its
``attrs``.  A span given a CUDA ``device`` also records a pair of CUDA
events on that card's current stream; :func:`drain`, called after the
card is synchronized, resolves them into ``device_ms``.

Records stay in memory, at most :data:`LIMIT` between two drains; the
ones past it are counted in ``lost`` and dropped.  Nothing is exported
beyond :func:`drain`::

    spans.enable()
    ...                       # the traced work
    spans.disable()
    torch.cuda.synchronize()
    records = spans.drain()
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, Optional

import torch

#: records held between two drains
LIMIT = 1 << 18

on = False
lost = 0
_records: List[Dict] = []
_index = itertools.count()
_local = threading.local()


class _Off:
    """What :func:`span` returns while tracing is off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


OFF = _Off()


class _Span:
    __slots__ = ("rec", "events")

    def __init__(self, name: str, device, attrs: Dict, wait: bool):
        self.rec = {"index": None, "name": name, "parent": None, "thread": None,
                    "t0_ns": None, "t1_ns": None, "wait": wait, "attrs": attrs}
        self.events = None
        if device is not None and device.type == "cuda":
            stream = torch.cuda.current_stream(device)
            self.events = (stream, torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))

    def set(self, **attrs) -> None:
        """Attributes known only once the span is open (callers check
        ``spans.on`` first: :data:`OFF` takes none)."""
        self.rec["attrs"].update(attrs)

    def __enter__(self):
        global lost
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        rec = self.rec
        rec["index"] = next(_index)
        rec["parent"] = stack[-1] if stack else None
        rec["thread"] = threading.get_ident()
        stack.append(rec["index"])
        if len(_records) < LIMIT:
            _records.append(rec)
        else:
            lost += 1
        if self.events is not None:
            self.events[1].record(self.events[0])
        rec["t0_ns"] = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.rec["t1_ns"] = time.time_ns()
        if self.events is not None:
            self.events[2].record(self.events[0])
            self.rec["_events"] = self.events[1:]
        _local.stack.pop()
        return False


def span(name: str, device: Optional[torch.device] = None, **attrs):
    """A context manager that records ``name`` while tracing is on.
    ``device``: the card whose current stream it also times with CUDA
    events (a CPU device, or None, times nothing)."""
    if not on:
        return OFF
    return _Span(name, device, attrs, False)


def wait(name: str, **attrs):
    """A span around a point where the host blocks on the card: a copy
    between host and card, or a read of a card's value."""
    if not on:
        return OFF
    return _Span(name, None, attrs, True)


def enable() -> None:
    """Start recording afresh: records not drained are dropped."""
    global on, lost, _records
    _records, lost = [], 0
    on = True


def disable() -> None:
    global on
    on = False


def drain() -> List[Dict]:
    """Every record since :func:`enable` or the last drain, in the order
    the spans opened; the buffer is left empty.  Synchronize the card
    first: a device span's ``device_ms`` is read from its events here."""
    global _records
    out, _records = _records, []
    for rec in out:
        events = rec.pop("_events", None)
        if events is not None:
            rec["device_ms"] = events[0].elapsed_time(events[1])
    return out
