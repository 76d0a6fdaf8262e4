"""The span recorder (``repro_torch.common.spans``) and its spans in the
serving engine and the distributed dataframe operators: off, it records
nothing and hands out one shared no-op; on, it nests per thread, bounds
its buffer, and the engine's and operators' span trees say what each
step and iteration did, with answers bitwise the same either way.

The ``-m cuda`` tests run on the card:

    PYTHONPATH=src python -m pytest -q -s -m cuda tests/test_torch_spans.py

the spans' clock against the device trace's, and whether a blocking
upload of the engine waits for the card's queue to drain.

This file imports no jax, so it runs where only torch is installed."""
import sys
import threading
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.common import spans  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.dataframe import ops_dist as D  # noqa: E402
from repro_torch.dataframe.table import Table  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.serve.engine import _bucket  # noqa: E402
from repro_torch.serve.request import Request  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CFG = get_config("tinyllama-1.1b", smoke=True).with_overrides(compute_dtype=torch.float32)


@pytest.fixture(autouse=True)
def _tracing_off():
    spans.disable()
    spans.drain()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    spans.disable()
    spans.drain()


def _traced(fn):
    spans.enable()
    try:
        out = fn()
    finally:
        spans.disable()
    return out, spans.drain()


# -- the recorder ---------------------------------------------------------------


def test_off_records_nothing_and_returns_the_shared_noop():
    assert not spans.on
    s = spans.span("a", device=torch.device("cpu"), x=1)
    assert s is spans.OFF and spans.wait("b", kind="upload") is spans.OFF
    with s:
        with spans.wait("b"):
            pass
    assert spans.drain() == []


def test_spans_nest_and_name_their_parents():
    def work():
        with spans.span("outer", n=1) as o:
            with spans.span("inner"):
                with spans.wait("w", kind="readback"):
                    pass
            o.set(m=2)
        with spans.span("next"):
            pass

    _, recs = _traced(work)
    by = {r["name"]: r for r in recs}
    assert [r["name"] for r in recs] == ["outer", "inner", "w", "next"]
    assert by["outer"]["parent"] is None and by["next"]["parent"] is None
    assert by["inner"]["parent"] == by["outer"]["index"]
    assert by["w"]["parent"] == by["inner"]["index"]
    assert by["w"]["wait"] and not by["inner"]["wait"]
    assert by["outer"]["attrs"] == {"n": 1, "m": 2} and by["w"]["attrs"] == {"kind": "readback"}
    for r in recs:
        assert r["t0_ns"] <= r["t1_ns"] and "device_ms" not in r
    o, i = by["outer"], by["inner"]
    assert o["t0_ns"] <= i["t0_ns"] <= i["t1_ns"] <= o["t1_ns"] <= by["next"]["t0_ns"]
    # the clock of the device trace's window
    assert abs(o["t0_ns"] - time.time_ns()) < 60e9


def test_each_thread_nests_on_its_own_stack():
    gate = threading.Barrier(2, timeout=30)

    def worker(tag):
        with spans.span(f"outer.{tag}"):
            gate.wait()          # both outers open before either inner
            with spans.span(f"inner.{tag}"):
                gate.wait()

    def work():
        ts = [threading.Thread(target=worker, args=(t,)) for t in "ab"]
        for t in ts:
            t.start()
        for t in ts:
            t.join(30)
        assert not any(t.is_alive() for t in ts)

    _, recs = _traced(work)
    by = {r["name"]: r for r in recs}
    assert len(recs) == 4
    for tag in "ab":
        outer, inner = by[f"outer.{tag}"], by[f"inner.{tag}"]
        assert outer["parent"] is None
        assert inner["parent"] == outer["index"]
        assert inner["thread"] == outer["thread"]
    assert by["outer.a"]["thread"] != by["outer.b"]["thread"]


def test_drain_empties_and_enable_starts_afresh():
    def work():
        for i in range(3):
            with spans.span(f"s{i}"):
                pass

    _, recs = _traced(work)
    assert len(recs) == 3 and spans.drain() == []
    spans.enable()
    with spans.span("left"):
        pass
    spans.enable()                 # not drained: dropped
    with spans.span("kept"):
        pass
    spans.disable()
    assert [r["name"] for r in spans.drain()] == ["kept"]


def test_the_buffer_is_bounded(monkeypatch):
    monkeypatch.setattr(spans, "LIMIT", 3)

    def work():
        for i in range(5):
            with spans.span("s", i=i):
                pass

    _, recs = _traced(work)
    assert [r["attrs"]["i"] for r in recs] == [0, 1, 2]
    assert spans.lost == 2


# -- the serving engine -------------------------------------------------------------


def _requests(seed=0, sampled=False):
    rng = np.random.default_rng(seed)
    out = []
    for j, n in enumerate((5, 21, 9, 14, 3)):
        kw = {"temperature": 0.8, "top_k": 5, "seed": 11 + j} if sampled and j % 2 else {}
        out.append(Request(rng.integers(0, CFG.vocab_size, n).astype(np.int32),
                           max_new_tokens=4, **kw))
    return out


def _serve(layout="paged", sampled=False, trace=False, slots=3):
    eng = ServeEngine(CFG, device="cpu", seed=3, kv_layout=layout, max_slots=slots,
                      max_len=48, prefill_chunk_tokens=16)
    reqs = [eng.submit(r) for r in _requests(sampled=sampled)]
    if trace:
        _, recs = _traced(eng.run_until_drained)
    else:
        eng.run_until_drained()
        recs = None
    return eng, reqs, recs


def test_the_steps_span_tree():
    eng, reqs, recs = _serve(trace=True)
    by_index = {r["index"]: r for r in recs}
    parent = lambda r: by_index[r["parent"]]["name"]  # noqa: E731
    steps = [r for r in recs if r["parent"] is None]
    assert steps and all(r["name"] == "serve.step" for r in steps)
    assert [r["attrs"]["step"] for r in steps] == list(range(len(steps)))
    kids = {"serve.admit", "serve.prefill", "serve.decode"}
    for r in recs:
        if r["name"] in kids:
            assert parent(r) == "serve.step"
        elif r["name"] == "serve.wait":
            assert r["wait"] and parent(r) in ("serve.prefill", "serve.decode")
            assert r["attrs"]["kind"] in ("upload", "readback")
        else:
            assert r["name"] == "serve.step"
        if r["parent"] is not None:
            p = by_index[r["parent"]]
            assert p["t0_ns"] <= r["t0_ns"] <= r["t1_ns"] <= p["t1_ns"]
    rids = [r.rid for r in reqs]
    admitted = [x for r in recs if r["name"] == "serve.admit" for x in r["attrs"]["rids"]]
    assert admitted == rids
    chunks = [r for r in recs if r["name"] == "serve.prefill"]
    assert sorted({x for c in chunks for x in c["attrs"]["rids"]}) == sorted(rids)
    assert sum(c["attrs"]["tokens"] for c in chunks) == sum(r.prompt_len for r in reqs)
    for c in chunks:
        a = c["attrs"]
        # paged: the slab is the rows that take tokens, bucketed
        assert a["rows"] == min(_bucket(len(a["rids"]), lo=1), eng.max_slots)
        assert a["slab"] == a["rows"] * a["T"] and a["tokens"] <= 16
        assert a["mb"] >= 1 and len(a["rids"]) >= 1
    st = eng.stats()
    assert st["prefill_slab_positions"] == sum(c["attrs"]["slab"] for c in chunks)
    assert st["prefill_tokens"] == sum(c["attrs"]["tokens"] for c in chunks)
    assert st["prefill_chunks"] == len(chunks)
    decodes = [r for r in recs if r["name"] == "serve.decode"]
    assert len(decodes) == st["decode_steps"]
    assert sum(d["attrs"]["rows"] for d in decodes) == st["decode_slot_steps"]
    # a greedy decode uploads its block table, tokens and lengths and reads
    # the tokens back; a chunk uploads four arrays and reads the first tokens
    # back when a prompt ends in it
    for d in decodes:
        waits = [r["attrs"]["kind"] for r in recs if r["parent"] == d["index"]]
        assert waits == ["upload"] * 3 + ["readback"] and not d["attrs"]["sampling"]
    for c in chunks:
        waits = [r["attrs"]["kind"] for r in recs if r["parent"] == c["index"]]
        assert waits[:4] == ["upload"] * 4 and set(waits[4:]) <= {"readback"}


@pytest.mark.parametrize("layout,sampled", [("paged", False), ("paged", True),
                                            ("contiguous", False), ("contiguous", True)])
def test_streams_are_the_same_with_tracing_on_and_off(layout, sampled):
    eng0, off, _ = _serve(layout, sampled)
    eng1, on, recs = _serve(layout, sampled, trace=True)
    assert [r.tokens for r in on] == [r.tokens for r in off]
    assert all(len(r.tokens) == 4 for r in off)
    assert not spans.on and recs
    s0, s1 = eng0.stats(), eng1.stats()
    for k in ("prefill_tokens", "prefill_chunks", "prefill_slab_positions", "decode_steps",
              "decode_slot_steps", "tokens_generated"):
        assert s0[k] == s1[k], k
    if sampled:
        # the step's uploads, the sampler's (keys, temperatures, top-k), its two reads
        d = next(r for r in recs if r["name"] == "serve.decode" and r["attrs"]["sampling"])
        kinds = [r["attrs"]["kind"] for r in recs if r["parent"] == d["index"]]
        assert kinds.count("readback") == 2
        assert kinds.count("upload") == (6 if layout == "paged" else 5)


def test_the_slab_counter_counts_whole_chunks_with_tracing_off():
    """``prefill_slab_positions`` is always on: each chunk's rows times its
    power-of-two width, against the prompt tokens they carry.  Paged, the
    rows are those that take tokens, bucketed; contiguous, every slot."""
    for layout in ("paged", "contiguous"):
        eng, reqs, _ = _serve(layout, slots=4)
        chunks = [r["attrs"] for r in _serve(layout, slots=4, trace=True)[2]
                  if r["name"] == "serve.prefill"]
        rows = [min(_bucket(len(a["rids"]), lo=1), 4) if layout == "paged" else 4
                for a in chunks]
        assert [a["rows"] for a in chunks] == rows
        st = eng.stats()
        assert st["prefill_chunks"] == len(chunks)
        assert st["prefill_slab_positions"] == sum(r * a["T"] for r, a in zip(rows, chunks))
        assert st["prefill_tokens"] == sum(r.prompt_len for r in reqs)
        assert st["prefill_tokens"] < st["prefill_slab_positions"]
        assert st["prefill_slab_positions"] <= 4 * 16 * st["prefill_chunks"]
    eng.reset_stats()
    assert "prefill_slab_positions" not in eng.stats()


def test_a_handoff_export_and_import_are_waits():
    eng = ServeEngine(CFG, device="cpu", seed=3, max_slots=2, max_len=48,
                      prefill_chunk_tokens=16, prefill_only=True)
    eng.submit(_requests()[1])
    _, recs = _traced(eng.run_until_drained)
    (hand,) = eng.take_handoffs()
    chunk = next(r for r in recs if r["name"] == "serve.prefill" and r["attrs"]["tokens"] == 5)
    kinds = [r["attrs"]["kind"] for r in recs if r["parent"] == chunk["index"]]
    # the chunk's four uploads, its first token, the gather's page ids, the pages
    assert kinds == ["upload"] * 4 + ["readback", "upload", "readback"]
    # a decode engine imports it in its admission: the page ids, then the pages
    dec = ServeEngine(CFG, params=eng.params, device="cpu", max_slots=2, max_len=48)
    dec.submit(hand)
    _, recs = _traced(dec.run_until_drained)
    admit = next(r for r in recs if r["name"] == "serve.admit" and r["attrs"]["rids"])
    assert admit["attrs"]["rids"] == [hand.request.rid]
    kinds = [r["attrs"]["kind"] for r in recs if r["parent"] == admit["index"]]
    assert kinds == ["upload", "upload"] and len(hand.request.tokens) == 4


# -- the distributed dataframe operators -----------------------------------------------

SUMMED = ("o_totalprice", "l_quantity", "_count", "o_orderkey")


def _q18_tables(shards=4, orders=256, seed=5):
    """Q18's columns at a few thousand rows, on a logical mesh of the CPU."""
    rng = np.random.default_rng(seed)
    okey = (np.arange(orders) * 3 + 1).astype(np.int32)
    lines = rng.integers(1, 8, orders)
    lkey = np.repeat(okey, lines)
    order = rng.permutation(lkey.size)
    n = lkey.size - lkey.size % shards
    lkey = lkey[order][:n]
    qty = rng.integers(1, 51, n).astype(np.float32)
    price = rng.uniform(850.0, 5.5e5, orders).astype(np.float32)
    mesh = make_mesh([shards], ["data"], device="cpu")
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    lineitem = Table.from_columns({"l_orderkey": t(lkey), "l_quantity": t(qty)}, mesh=mesh)
    orders_t = Table.from_columns({"o_orderkey": t(okey), "o_totalprice": t(price)}, mesh=mesh)
    return lineitem, orders_t


def _q18_iteration(lineitem, orders):
    """The benchmark's Q18 iteration: group-by, having, join, reduce."""
    g, d_group = D.groupby_sum(lineitem, "l_orderkey", ["l_quantity"],
                               groups_cap_per_shard=512)
    c = g.columns
    big = Table({"o_orderkey": c["l_orderkey"], "l_quantity": c["l_quantity"],
                 "_count": c["_count"]}, g.valid & (c["l_quantity"] > 100.0), g.mesh, g.axis)
    j, d_join = D.join(big, orders, "o_orderkey")
    return g, j, D.reduce_sum(j, list(SUMMED)), d_group + d_join


def test_a_q18_iteration_span_tree():
    lineitem, orders = _q18_tables()
    (g, j, sums, dropped), recs = _traced(lambda: _q18_iteration(lineitem, orders))
    by_index = {r["index"]: r for r in recs}
    parent = lambda r: by_index[r["parent"]]["name"] if r["parent"] is not None else None  # noqa: E731
    assert [r["name"] for r in recs if r["parent"] is None] == [
        "df.groupby_sum", "df.join", "df.reduce_sum"]
    assert [r["name"] for r in recs].count("df.wait") == 7
    exchanges = [r for r in recs if r["name"] == "df.exchange"]
    assert [parent(r) for r in exchanges] == ["df.groupby_sum", "df.join", "df.join"]
    assert [parent(r) for r in recs if r["name"] == "df.local_groupby"] == ["df.groupby_sum"]
    assert [parent(r) for r in recs if r["name"] == "df.local_join"] == ["df.join"]
    waits = [r for r in recs if r["name"] == "df.wait"]
    assert [parent(r) for r in waits] == ["df.exchange"] * 3 + ["df.reduce_sum"] * 4
    assert all(r["wait"] for r in waits)
    # slots N * cap, the columns exchanged, their bucket bytes plus the keep mask
    N, per = 4, lineitem.valid.numel() // 4
    cap = max(int(per / N * 2.0), 16)
    a = exchanges[0]["attrs"]
    assert a == {"slots": N * cap, "columns": 2, "bytes": N * N * cap * (4 + 4 + 1)}
    for r in exchanges[1:]:
        assert r["attrs"]["columns"] in (2, 3) and r["attrs"]["bytes"] > 0
    # on the CPU no span is timed on a card
    assert not any("device_ms" in r for r in recs)


def test_q18_answers_are_the_same_with_tracing_on_and_off():
    lineitem, orders = _q18_tables(seed=9)
    g0, j0, sums0, d0 = _q18_iteration(lineitem, orders)
    (g1, j1, sums1, d1), recs = _traced(lambda: _q18_iteration(lineitem, orders))
    assert recs and sums0 == sums1 and d0 == d1
    for a, b in ((g0, g1), (j0, j1)):
        assert torch.equal(a.valid, b.valid)
        assert a.columns.keys() == b.columns.keys()
        for k in a.columns:
            assert torch.equal(a.columns[k], b.columns[k]), k
    assert sums0["_count"] > 0


def test_the_analysis_gate_finds_nothing_and_no_sync_is_marked_quiet():
    """The spans add no host sync the port's passes see, and quiet none
    with a ``# sync-ok`` marker."""
    from repro_torch.analysis import __main__ as cli

    assert cli.run_passes(cli.ALL_PASSES) == []
    for rel in ("common/spans.py", "serve/engine.py", "dataframe/ops_dist.py"):
        assert "sync-ok" not in (ROOT / "src" / "repro_torch" / rel).read_text()


# -- on the card -----------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card)")


def _device_trace():
    """The benchmark's device trace (``port_bench/harness/trace.py``)."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from port_bench.harness.trace import DeviceTrace

    return DeviceTrace


def _sleep_cycles(ms: float) -> int:
    """Cycles of ``torch.cuda._sleep`` that take about ``ms`` on this card."""
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1000)
    e0.record()
    torch.cuda._sleep(1_000_000)
    e1.record()
    torch.cuda.synchronize()
    return int(1_000_000 * ms / e0.elapsed_time(e1))


@pytest.mark.cuda
def test_spans_and_the_device_trace_share_a_clock():
    """A kernel launched inside a span starts inside it on the trace (or
    within 0.5 ms after it closes); an idle gap made by a host sleep inside
    a nested span is named by that innermost span."""
    _card()
    tr = _device_trace()(torch)
    cycles = _sleep_cycles(2.0)
    tr.start()                       # the profiler's first start sets up CUPTI
    torch.cuda._sleep(1000)
    tr.stop()
    tr.start()
    spans.enable()
    try:
        with spans.span("test.outer"):
            with spans.span("test.launch", device=torch.device("cuda")):
                torch.cuda._sleep(cycles)
            torch.cuda.synchronize()
            with spans.span("test.host"):
                time.sleep(0.02)
            torch.cuda._sleep(cycles)
            torch.cuda.synchronize()
    finally:
        spans.disable()
    tr.stop()
    recs = {r["name"]: r for r in spans.drain()}
    launch = recs["test.launch"]
    kernels = sorted(tr.events, key=lambda e: e[1])
    assert len(kernels) >= 2, tr.diagnostics()
    first = kernels[0]
    print(f"\n{torch.cuda.get_device_name(0)}: kernel starts {(first[1] - launch['t0_ns']) / 1e6:.3f}"
          f" ms after the span opens; the span lasts {(launch['t1_ns'] - launch['t0_ns']) / 1e6:.3f}"
          f" ms; device_ms {launch['device_ms']:.3f}; trace {tr.diagnostics()}")
    assert launch["t0_ns"] <= first[1] <= launch["t1_ns"] + 500_000
    assert launch["device_ms"] >= 1.0
    # innermost first: the covering span that started last names a gap
    named = sorted(((r["name"], r["t0_ns"] / 1e9, r["t1_ns"] / 1e9) for r in recs.values()),
                   key=lambda s: -s[1])
    gaps = tr.breakdown(named)["idle_gaps"]
    print(f"idle gaps: {gaps}")
    assert gaps[0][0] == "test.host" and gaps[0][1] >= 0.019


@pytest.mark.cuda
def test_a_blocking_upload_waits_for_the_cards_queue():
    """The engine's ``_tensor`` copies from pageable host memory with a
    blocking ``.to``: queued behind a 50 ms kernel, its ``serve.wait``
    lasts until the kernel ends, so every upload of a step drains the
    card's queue."""
    _card()
    eng = ServeEngine(get_config("tinyllama-1.1b", smoke=True), device="cuda", max_slots=2,
                      max_len=32)
    cycles = _sleep_cycles(50.0)
    a = np.arange(64, dtype=np.int32)
    eng._tensor(a)
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    spans.enable()
    try:
        e0.record()
        torch.cuda._sleep(cycles)
        e1.record()
        t = eng._tensor(a)
        r = eng._read(t)
    finally:
        spans.disable()
    torch.cuda.synchronize()
    kernel_ms = e0.elapsed_time(e1)
    up, back = spans.drain()
    up_ms, back_ms = ((x["t1_ns"] - x["t0_ns"]) / 1e6 for x in (up, back))
    print(f"\n{torch.cuda.get_device_name(0)}: kernel {kernel_ms:.2f} ms, upload wait "
          f"{up_ms:.2f} ms, readback wait {back_ms:.2f} ms")
    assert (up["attrs"]["kind"], back["attrs"]["kind"]) == ("upload", "readback")
    assert np.array_equal(r, a)
    assert up_ms >= 0.8 * kernel_ms
