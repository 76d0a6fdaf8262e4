"""Port parity: the ``repro_torch`` ServeEngine against ``repro.serve``:
token-identical greedy streams on the mixed workload with shared weights
(fp32 compute), page reuse and pool-exhaustion recovery, checkpoint /
restore, and the default device."""
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
from repro_torch.common.params import from_jax_params  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.serve import RequestState, ServeEngine  # noqa: E402
from repro_torch.serve.engine import _bucket  # noqa: E402

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
    # the same scheduling and shape buckets, and the same stats keys
    js, ts = jeng.stats(), eng.stats()
    assert set(ts) == set(js)
    for key in ("decode_steps", "prefill_chunks", "peak_pages", "retraces",
                "retraces_prefill", "retraces_decode", "tokens_generated"):
        assert ts[key] == js[key], key


def _prompts(rng, lens):
    return [rng.integers(1, CFG.vocab_size, int(n)).astype(np.int32) for n in lens]


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
