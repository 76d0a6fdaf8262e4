"""The device trace of a window: ``torch.profiler`` over the card alone
(a host trace of every op takes minutes to reduce), read from the raw
kineto events, and reduced to busy time, kernel time by name, and idle
gaps named by what the benchmark's own host spans say the host was doing.
"""
from __future__ import annotations

import time
from typing import Dict, List, Sequence, Tuple

from torch.autograd import DeviceType


class DeviceTrace:
    def __init__(self, torch):
        self.torch = torch
        self.prof = None
        self.t0_ns = self.t1_ns = 0
        self.events: List[Tuple[str, int, int]] = []   # (name, start ns, end ns)

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self.torch.cuda.synchronize()
        self.t0_ns = time.time_ns()

    def stop(self) -> None:
        self.torch.cuda.synchronize()
        self.t1_ns = time.time_ns()
        self.prof.stop()
        evs = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            s = e.start_ns()
            evs.append((e.name(), s, s + e.duration_ns()))
        self.events = sorted(evs, key=lambda x: x[1])
        self.prof = None

    # -- reductions -------------------------------------------------------------

    def diagnostics(self) -> Dict:
        """Events in the trace, and how many end before or start after the
        host's window (a device clock that is not the host's shows here)."""
        return {"events": len(self.events),
                "before": sum(1 for _, _, e in self.events if e < self.t0_ns),
                "after": sum(1 for _, s, _ in self.events if s > self.t1_ns),
                "first_ns": self.events[0][1] - self.t0_ns if self.events else None,
                "last_ns": self.t1_ns - self.events[-1][2] if self.events else None}

    @property
    def window_s(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9

    def clipped(self):
        """Events inside the window; the device clock is taken as the
        host's, as the profiler converts it."""
        a, b = self.t0_ns, self.t1_ns
        for n, s, e in self.events:
            s, e = max(s, a), min(e, b)
            if e > s:
                yield n, s, e

    def busy_s(self) -> float:
        busy, end = 0, None
        for _, s, e in self.clipped():
            if end is None or s > end:
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        return busy / 1e9

    def time_by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for n, s, e in self.clipped():
            out[n] = out.get(n, 0.0) + (e - s) / 1e9
        return out

    def gaps(self) -> List[Tuple[int, int]]:
        out, end = [], self.t0_ns
        for _, s, e in self.clipped():
            if s > end:
                out.append((end, s))
            end = max(end, e)
        if self.t1_ns > end:
            out.append((end, self.t1_ns))
        return out

    def breakdown(self, spans: Sequence[Tuple[str, float, float]]) -> Dict:
        """Top device ops by time, and the longest idle gaps, each named by
        the host span (name, start s, end s on time.time()) that covers
        its middle."""
        ops = sorted(self.time_by_name().items(), key=lambda kv: -kv[1])[:10]
        named = []
        for a, b in self.gaps():
            mid = (a + b) / 2e9
            host = next((n for n, s, e in spans if s <= mid <= e), "harness loop")
            named.append([host, (b - a) / 1e9])
        named.sort(key=lambda x: -x[1])
        return {"device_ops": [[n[:120], v] for n, v in ops], "idle_gaps": named[:10]}
