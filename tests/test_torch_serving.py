"""Port parity: the ``repro_torch`` ServeEngine against ``repro.serve``:
token-identical greedy streams on the mixed workload with shared weights
(fp32 compute), a paged chunk of only the rows that take tokens (greedy
and seeded streams, a filler row that writes no page), page reuse and
pool-exhaustion recovery, checkpoint / restore, and the default device."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from benchmarks.workload import mixed_workload  # noqa: E402
from repro.common.params import init_params  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.serve.engine import _bucket as j_bucket  # noqa: E402
from repro.train.state import model_specs  # noqa: E402
from repro_torch.common.params import from_jax_params, map_tree, tree_leaves  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.serve import RequestState, ServeEngine  # noqa: E402
from repro_torch.serve.engine import _bucket, _map_cache  # noqa: E402

JCFG = dataclasses.replace(jget("tinyllama-1.1b", smoke=True), compute_dtype=jnp.float32)
CFG = tget("tinyllama-1.1b", smoke=True)
CFG32 = CFG.with_overrides(compute_dtype=torch.float32)


@pytest.fixture(scope="module")
def params():
    jp = init_params(jax.random.PRNGKey(0), model_specs(JCFG))
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # the CPU is shared with the other test workers: torch's intra-op pool
    # only contends for it at these sizes
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _engine(tp, cfg=CFG32, **kw):
    return ServeEngine(cfg, params=tp, device="cpu", **kw)


def _serve(eng, work):
    reqs = [eng.submit(p, max_new_tokens=int(g)) for p, g in work]
    eng.run_until_drained()
    return reqs


@pytest.mark.parametrize("chunk", [64, None])
@pytest.mark.parametrize("slots", [2, 4])
def test_streams_match_jax_engine(params, slots, chunk):
    jp, tp = params
    work = [(p, g) for _, p, g in mixed_workload(8, seed=0)]
    kw = dict(max_slots=slots, max_len=256, prefill_chunk_tokens=chunk)
    jeng = JEngine(JCFG, params=jp, **kw)
    want = _serve(jeng, work)
    eng = _engine(tp, **kw)
    got = _serve(eng, work)
    assert all(r.state is RequestState.DONE for r in got)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    # the same scheduling and shape buckets, and the same stats keys (the
    # port's own: the chunks' slab positions)
    js, ts = jeng.stats(), eng.stats()
    assert set(ts) == set(js) | {"prefill_slab_positions"}
    for key in ("decode_steps", "prefill_chunks", "peak_pages", "retraces",
                "retraces_prefill", "retraces_decode", "tokens_generated"):
        assert ts[key] == js[key], key


def _prompts(rng, lens):
    return [rng.integers(1, CFG.vocab_size, int(n)).astype(np.int32) for n in lens]


def _record_chunks(eng):
    """Wrap the engine's chunk step: each call's (rows, T, rows taking
    tokens, longest take)."""
    seen, inner = [], eng._prefill_chunk

    def chunk(params, tokens, base, clens, cache, bt):
        c = clens.cpu().numpy()
        seen.append((tokens.shape[0], tokens.shape[1], int((c > 0).sum()), int(c.max())))
        return inner(params, tokens, base, clens, cache, bt)

    eng._prefill_chunk = chunk
    return seen


def _staggered(eng, work, start=2, every=2):
    """Submit ``start`` requests, then one every ``every`` steps, and step
    until drained: prompts overlap, so a few rows take tokens at once."""
    reqs = [eng.submit(p, **kw) for p, kw in work[:start]]
    pending, step = list(work[start:]), 0
    while pending or eng.has_work():
        if pending and step % every == 0:
            p, kw = pending.pop(0)
            reqs.append(eng.submit(p, **kw))
        eng.step()
        step += 1
    return reqs


@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("chunk", [16, 64])
def test_compacted_chunk_streams_match_jax_engine(params, chunk, sampled):
    """Eight paged slots, staggered prompts: a chunk's slab holds only the
    rows that take tokens (1-3 here, bucketed to a power of two), yet the
    greedy and seeded streams, the shape buckets and the schedule are the
    JAX engine's, which runs all eight rows."""
    jp, tp = params
    lens = [37, 5, 21, 9, 50, 3, 14, 28, 7, 40, 11, 19]
    work = []
    for j, p in enumerate(_prompts(np.random.default_rng(21), lens)):
        kw = {"max_new_tokens": 6 + j % 5}
        if sampled and j % 2:
            kw.update(temperature=0.9, top_k=(0, 5)[j % 4 // 2], seed=2**32 + 7 * j)
        work.append((p, kw))
    kw = dict(max_slots=8, max_len=128, prefill_chunk_tokens=chunk)
    jeng = JEngine(JCFG, params=jp, **kw)
    want = _staggered(jeng, work)
    eng = _engine(tp, **kw)
    seen = _record_chunks(eng)
    got = _staggered(eng, work)
    assert all(r.state is RequestState.DONE for r in got)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    js, ts = jeng.stats(), eng.stats()
    for key in ("decode_steps", "prefill_chunks", "peak_pages", "retraces",
                "retraces_prefill", "retraces_decode", "tokens_generated"):
        assert ts[key] == js[key], key
    for R, T, n, take in seen:
        assert R == min(_bucket(n, lo=1), 8) and T == _bucket(take)
    # 1-3 rows take tokens at once, and 3 (-> 4 rows) puts a filler row in
    taking = {n for _, _, n, _ in seen}
    assert 3 in taking and taking <= {1, 2, 3}
    assert ts["prefill_slab_positions"] == sum(R * T for R, T, _, _ in seen)
    assert ts["prefill_chunks"] == len(seen)


def test_a_filler_row_writes_no_page(params):
    """Three prompts take tokens in one chunk: four rows run, the fourth
    a filler (no tokens, an all-sentinel table row).  Over a pool filled
    with noise, every page outside the three real rows' tables is bitwise
    what it was, and the streams are still the JAX engine's."""
    jp, tp = params
    work = [(p, {"max_new_tokens": 5}) for p in _prompts(np.random.default_rng(4), [5, 7, 9])]
    kw = dict(max_slots=8, max_len=64, page_size=8, prefill_chunk_tokens=64)
    jeng = JEngine(JCFG, params=jp, **kw)
    want = _staggered(jeng, work, start=3)
    eng = _engine(tp, **kw)
    gen = torch.Generator().manual_seed(0)
    eng.cache = map_tree(lambda t: t.copy_(torch.randn(t.shape, generator=gen)), eng.cache)
    before = map_tree(torch.clone, eng.cache)
    seen = _record_chunks(eng)
    reqs = [eng.submit(p, **k) for p, k in work]
    eng.step()
    assert seen == [(4, 16, 3, 9)]
    owned = torch.tensor(sorted(p for ps in eng.slot_pages for p in ps))
    assert len(owned) == 1 + 1 + 2  # pages of 8: the decode appends fit in them
    keep = torch.ones(eng.num_pages, dtype=torch.bool)
    keep[owned] = False
    same = _map_cache(lambda a, b: torch.equal(a[keep], b[keep]),
                      lambda a, b: torch.equal(a[:, keep], b[:, keep]), before, eng.cache)
    assert all(tree_leaves(same))
    eng.run_until_drained()
    assert [r.tokens for r in reqs] == [r.tokens for r in want]


def test_page_reuse_after_eviction(params):
    """Two pages in the pool: one request fits at a time, yet all five
    complete because finished slots recycle their pages."""
    eng = _engine(params[1], cfg=CFG, max_slots=2, max_len=32, page_size=8,
                  num_pages=2)
    reqs = _serve(eng, [(p, 6) for p in _prompts(np.random.default_rng(11),
                                                 [5, 7, 4, 6, 5])])
    for r in reqs:
        assert r.state is RequestState.DONE and len(r.tokens) == 6
    assert eng.stats()["peak_pages"] <= 2
    assert eng.pages_in_use() == 0
    assert sorted(eng.free_pages) == [0, 1]
    assert (eng.block_table == eng.num_pages).all()


def test_pool_exhaustion_fails_slot_then_recovers(params):
    eng = _engine(params[1], cfg=CFG, max_slots=1, max_len=64, page_size=8,
                  num_pages=2)
    hog = eng.submit(np.arange(1, 7, dtype=np.int32), max_new_tokens=40)
    eng.run_until_drained()
    assert hog.state is RequestState.FAILED and "page pool exhausted" in hog.error
    ok = eng.submit(np.arange(1, 7, dtype=np.int32), max_new_tokens=8)
    eng.run_until_drained()
    assert ok.state is RequestState.DONE and len(ok.tokens) == 8
    assert eng.pages_in_use() == 0


def test_unservable_prompt_fails_fast(params):
    eng = _engine(params[1], cfg=CFG, max_slots=1, max_len=64, page_size=8,
                  num_pages=2)
    hog = eng.submit(np.arange(1, 22, dtype=np.int32), max_new_tokens=2)
    ok = eng.submit(np.arange(1, 7, dtype=np.int32), max_new_tokens=4)
    eng.run_until_drained()
    assert hog.state is RequestState.FAILED and "pool" in hog.error
    assert ok.state is RequestState.DONE and len(ok.tokens) == 4


def test_oversized_prompt_fails(params):
    eng = _engine(params[1], cfg=CFG, max_slots=1, max_len=16)
    bad = eng.submit(np.ones(16, np.int32), max_new_tokens=2)
    ok = eng.submit(np.ones(4, np.int32), max_new_tokens=2)
    eng.run_until_drained()
    assert bad.state is RequestState.FAILED and "fit" in bad.error
    assert ok.state is RequestState.DONE and len(ok.tokens) == 2


def test_checkpoint_restore_roundtrip(params):
    """checkpoint/restore mid-generation (page pool, block tables, free
    list): the resumed engine finishes with the uninterrupted streams."""
    # the long prompt first: at the checkpoint a slot is mid-prefill
    prompts = _prompts(np.random.default_rng(12), [30, 5, 9])
    want = [r.tokens for r in _serve(
        _engine(params[1], max_slots=2, max_len=64, page_size=8,
                prefill_chunk_tokens=8), [(p, 10) for p in prompts])]
    eng = _engine(params[1], max_slots=2, max_len=64, page_size=8,
                  prefill_chunk_tokens=8)
    reqs = [eng.submit(p, max_new_tokens=10) for p in prompts]
    for _ in range(4):
        eng.step()
    state = eng.checkpoint()
    assert (state["prefill_pos"] > 0).any()
    eng._release_state()
    assert eng.pages_in_use() == 0
    eng.restore(state)
    assert np.array_equal(eng.block_table, state["block_table"])
    assert eng.free_pages == state["free_pages"]
    eng.run_until_drained()
    assert [r.tokens for r in reqs] == want


def test_default_device_is_the_card():
    """device=None means cuda; without a GPU it raises instead of quietly
    running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default is usable here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(CFG)


def test_bucket_matches_jax():
    for n in range(1, 70):
        assert _bucket(n) == j_bucket(n)
        assert _bucket(n, lo=1) == j_bucket(n, lo=1)
