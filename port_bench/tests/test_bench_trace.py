"""The trace reductions on hand-made device events: busy time is the
union of the intervals inside the window, gaps are named by the host
span that covers their middle."""
import torch

from port_bench.harness.trace import DeviceTrace


def _trace():
    t = DeviceTrace(torch)
    t.t0_ns, t.t1_ns = 1_000, 11_000
    # two overlapping kernels, one clipped at the window's start, one after it
    t.events = [("k_a", 500, 2_000), ("k_b", 3_000, 6_500), ("k_a", 5_000, 7_000),
                ("k_c", 12_000, 13_000)]
    return t


def test_busy_is_the_union_inside_the_window():
    t = _trace()
    assert t.window_s == 1e-5
    assert t.busy_s() == (1_000 + 4_000) / 1e9
    assert t.time_by_name() == {"k_a": (1_000 + 2_000) / 1e9, "k_b": 3_500 / 1e9}
    assert t.gaps() == [(2_000, 3_000), (7_000, 11_000)]


def test_gaps_are_named_by_the_host_span_over_their_middle():
    t = _trace()
    spans = [("engine.step", 1.5e-6, 4e-6)]
    b = t.breakdown(spans)
    assert b["device_ops"][0][0] == "k_b"
    assert b["idle_gaps"] == [["harness loop", 4e-6], ["engine.step", 1e-6]]
