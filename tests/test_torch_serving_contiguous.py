"""Port parity on the contiguous slot cache (``kv_layout="contiguous"``):
``lm_apply`` logits and caches, ``make_prefill_step(with_cache=True)``,
a token-replay generate loop, and ``ServeEngine`` streams and stats
against ``repro`` on the tinyllama smoke config with shared weights in
fp32; the port's contiguous streams against its paged ones; the guard
that keeps rows that must not decode intact; checkpoint / restore; and
the monitoring API."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from benchmarks.workload import mixed_workload  # noqa: E402
from repro.common.params import init_params, is_param  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.train import state as jstate  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch.common.params import from_jax_params, map_tree  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.serve import RequestState, ServeEngine  # noqa: E402
from repro_torch.train import state as tstate  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

TOL = dict(atol=2e-5, rtol=2e-5)
JCFG = dataclasses.replace(jget("tinyllama-1.1b", smoke=True), compute_dtype=jnp.float32)
CFG = tget("tinyllama-1.1b", smoke=True)
CFG32 = CFG.with_overrides(compute_dtype=torch.float32)


@pytest.fixture(scope="module")
def params():
    jp = init_params(jax.random.PRNGKey(0), jstate.model_specs(JCFG))
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # the CPU is shared with the other test workers: torch's intra-op pool
    # only contends for it at these sizes
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _warm_caches(rng, B, S):
    jc = jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(p.shape), jnp.float32),
                      jlm.lm_cache_specs(JCFG, B, S), is_leaf=is_param)
    return jc, from_jax_params(jax.tree.map(np.asarray, jc), "cpu")


def _assert_caches(tc, jc, exact=False):
    for kind in ("k", "v"):
        got, want = tc["unit"]["b0"][kind].numpy(), np.asarray(jc["unit"]["b0"][kind])
        if exact:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, **TOL)


# -- specs ----------------------------------------------------------------------


def _shapes(tree, is_leaf):
    if isinstance(tree, dict):
        return {k: _shapes(v, is_leaf) for k, v in tree.items()}
    assert is_leaf(tree)
    return (tuple(tree.shape), str(tree.dtype).removeprefix("torch."), tree.init)


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "phi3-mini-3.8b"])
def test_cache_specs_match_jax(arch, smoke):
    j, t = jget(arch, smoke=smoke), tget(arch, smoke=smoke)
    want = jax.tree.map(lambda p: (tuple(p.shape), np.dtype(p.dtype).name, p.init),
                        jstate.cache_specs(j, 3, 40), is_leaf=is_param)
    assert _shapes(tstate.cache_specs(t, 3, 40), lambda x: True) == want
    assert _shapes(tlm.lm_cache_specs(t, 3, 40), lambda x: True) == want


# -- lm_apply ------------------------------------------------------------------


def test_lm_prefill_then_decodes_match(params):
    """A ragged chunked prefill over a warm cache (rows at different
    bases, one reaching the end of the row, an inert row), a [B] decode
    with a row past the cache (its write drops), then a scalar decode
    at S (the write clamps to S-1): logits and caches against JAX."""
    jp, tp = params
    rng = np.random.default_rng(3)
    B, T, S = 4, 8, 24
    jc, tc = _warm_caches(rng, B, S)
    tokens = rng.integers(1, JCFG.vocab_size, (B, T)).astype(np.int32)
    base = np.array([0, 5, 0, 18], np.int32)
    clens = np.array([8, 6, 0, 6], np.int32)

    jl, jc, _ = jlm.lm_apply(JCFG, jp, jnp.asarray(tokens), None, jc, jnp.asarray(base),
                             chunk_lens=jnp.asarray(clens), remat=False)
    tl, tc, _ = tlm.lm_apply(CFG32, tp, _t(tokens), None, tc, _t(base),
                             chunk_lens=_t(clens))
    valid = np.arange(T)[None, :] < clens[:, None]
    np.testing.assert_allclose(tl.numpy()[valid], np.asarray(jl)[valid], **TOL)
    _assert_caches(tc, jc)

    lens = np.array([8, 11, S, 23], np.int32)  # row 2 is past the cache
    step_tok = rng.integers(1, JCFG.vocab_size, (B, 1)).astype(np.int32)
    jl, jc, _ = jlm.lm_apply(JCFG, jp, jnp.asarray(step_tok), None, jc,
                             jnp.asarray(lens), remat=False)
    tl, tc, _ = tlm.lm_apply(CFG32, tp, _t(step_tok), None, tc, _t(lens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_caches(tc, jc)

    for pos in (12, S, S + 3):  # in range, then clamped to S-1
        jl, jc, _ = jlm.lm_apply(JCFG, jp, jnp.asarray(step_tok), None, jc,
                                 jnp.asarray(pos, jnp.int32), remat=False)
        tl, tc, _ = tlm.lm_apply(CFG32, tp, _t(step_tok), None, tc,
                                 torch.tensor(pos, dtype=torch.int32))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _assert_caches(tc, jc)


def test_prefill_step_with_cache_matches_jax(params):
    jp, tp = params
    rng = np.random.default_rng(1)
    lens = np.array([5, 9, 7, 1], np.int32)
    tokens = np.zeros((len(lens), 9), np.int32)
    for i, n in enumerate(lens):
        tokens[i, :n] = rng.integers(1, JCFG.vocab_size, n)
    jt, jlast, jc = jstep.make_prefill_step(JCFG, with_cache=True, max_len=32)(
        jp, jnp.asarray(tokens), jnp.asarray(lens))
    tt, tlast, tc = tstep.make_prefill_step(CFG32, with_cache=True, max_len=32)(
        tp, _t(tokens), _t(lens))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), **TOL)
    _assert_caches(tc, jc)


def test_prefill_step_without_cache_is_the_training_slice(params):
    """Landed with the training slice: the last position's logits of the
    no-cache forward."""
    tp = params[1]
    tok = torch.from_numpy(np.random.default_rng(9).integers(
        1, CFG32.vocab_size, (2, 6)).astype(np.int32))
    got = tstep.make_prefill_step(CFG32)(tp, {"tokens": tok})
    want, _, _ = tlm.lm_apply(CFG32, tp, tok, remat=False)
    torch.testing.assert_close(got, want[:, -1], rtol=0, atol=0)


def test_replay_generate_matches_jax(params):
    """Token-by-token: replay the prompt through scalar-length decode
    steps, then decode greedily (the reference loop of
    tests/test_serving.py) in both packages."""
    jp, tp = params
    prompt = np.random.default_rng(2).integers(1, JCFG.vocab_size, 7).astype(np.int32)
    n_new, max_len = 6, 16

    def generate(decode, cache, tokens_of, length_of, to_np):
        tok = logits = None
        for t in range(len(prompt)):
            tok, logits, cache = decode(tokens_of(prompt[None, t:t + 1]), cache, length_of(t))
        out = [int(to_np(tok)[0])]
        for pos in range(len(prompt), len(prompt) + n_new - 1):
            tok, logits, cache = decode(tokens_of(to_np(tok)[:, None]), cache, length_of(pos))
            out.append(int(to_np(tok)[0]))
        return out, to_np(logits)[0, -1], cache

    jdec = jax.jit(jstep.make_decode_step(JCFG))
    want, wl, wc = generate(
        lambda tok, c, n: jdec(jp, tok, c, n),
        jax.tree.map(lambda p: jnp.zeros(p.shape, p.dtype),
                     jlm.lm_cache_specs(JCFG, 1, max_len), is_leaf=is_param),
        jnp.asarray, lambda t: jnp.asarray(t, jnp.int32), np.asarray)
    tdec = tstep.make_decode_step(CFG32)
    got, gl, gc = generate(
        lambda tok, c, n: tdec(tp, tok, c, n),
        map_tree(lambda p: torch.zeros(p.shape, dtype=p.dtype),
                 tlm.lm_cache_specs(CFG32, 1, max_len)),
        _t, lambda t: torch.tensor(t, dtype=torch.int32), lambda x: x.numpy())
    assert got == want
    np.testing.assert_allclose(gl, wl, **TOL)
    _assert_caches(gc, wc)


# -- engine ----------------------------------------------------------------------


def _engine(tp, cfg=CFG32, **kw):
    return ServeEngine(cfg, params=tp, device="cpu", **kw)


def _serve(eng, work):
    reqs = [eng.submit(p, max_new_tokens=int(g)) for p, g in work]
    eng.run_until_drained()
    return reqs


@pytest.mark.parametrize("chunk", [64, None])
@pytest.mark.parametrize("slots", [2, 4])
def test_streams_match_jax_contiguous_engine(params, slots, chunk):
    jp, tp = params
    work = [(p, g) for _, p, g in mixed_workload(8, seed=0)]
    kw = dict(max_slots=slots, max_len=256, prefill_chunk_tokens=chunk,
              kv_layout="contiguous")
    jeng = JEngine(JCFG, params=jp, **kw)
    want = _serve(jeng, work)
    eng = _engine(tp, **kw)
    got = _serve(eng, work)
    assert all(r.state is RequestState.DONE for r in got)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    js, ts = jeng.stats(), eng.stats()
    assert set(ts) == set(js) | {"prefill_slab_positions"}
    for key in ("kv_layout", "decode_steps", "prefill_chunks", "retraces",
                "retraces_prefill", "retraces_decode", "tokens_generated",
                "kv_cache_bytes", "kv_cache_capacity_bytes", "kv_bytes_step_sum",
                "kv_tokens_step_sum", "kv_bytes_per_token", "slot_occupancy"):
        assert ts[key] == js[key], key


def test_contiguous_streams_equal_paged_streams(params):
    """The layout is invisible to the math: the port's contiguous engine
    emits its paged engine's streams."""
    tp = params[1]
    work = [(p, g) for _, p, g in mixed_workload(6, seed=3)]
    outs = {}
    for layout in ("paged", "contiguous"):
        reqs = _serve(_engine(tp, max_slots=3, max_len=256, page_size=8,
                              prefill_chunk_tokens=16, kv_layout=layout), work)
        assert all(r.state is RequestState.DONE for r in reqs)
        outs[layout] = [r.tokens for r in reqs]
    assert outs["paged"] == outs["contiguous"]


def test_rows_that_must_not_decode_stay_bitwise_intact(params):
    """The decode step that follows a mid-prefill slot's first chunk (its
    prompt now at position 0 on, its length still 0) leaves that slot's
    rows and a free slot's rows of every layer's cache bitwise
    unchanged."""
    eng = _engine(params[1], max_slots=3, max_len=64, prefill_chunk_tokens=6,
                  kv_layout="contiguous")
    rng = np.random.default_rng(7)
    eng.submit(rng.integers(1, CFG.vocab_size, 4).astype(np.int32), max_new_tokens=20)
    eng.step()  # the short prompt finishes its prefill and decodes
    snaps = []
    decode = eng._decode

    def snapshot_decode(*args):
        snaps.append(map_tree(torch.clone, args[2]))
        out = decode(*args)
        snaps.append(map_tree(torch.clone, out[2]))
        return out

    eng._decode = snapshot_decode
    eng.submit(rng.integers(1, CFG.vocab_size, 30).astype(np.int32), max_new_tokens=2)
    eng.step()  # the long prompt's first chunk, then a decode of slot 0
    assert eng.prefill_pos[1] == 6 and eng.lengths[1] == 0 and eng.slots[2] is None
    before, after = snaps
    for kind in ("k", "v"):
        was, now = before["unit"]["b0"][kind], after["unit"]["b0"][kind]
        assert torch.equal(now[:, 1:], was[:, 1:])
        assert was[:, 1, :6].abs().sum() > 0  # the chunk is there to lose
        assert not torch.equal(now[:, 0], was[:, 0])  # the decoding slot wrote


def test_checkpoint_restore_roundtrip(params):
    """checkpoint/restore mid-generation on the slot cache: the resumed
    engine finishes with the uninterrupted streams."""
    prompts = [np.random.default_rng(12).integers(1, CFG.vocab_size, n).astype(np.int32)
               for n in (30, 5, 9)]
    kw = dict(max_slots=2, max_len=64, prefill_chunk_tokens=8, kv_layout="contiguous")
    want = [r.tokens for r in _serve(_engine(params[1], **kw), [(p, 10) for p in prompts])]
    eng = _engine(params[1], **kw)
    reqs = [eng.submit(p, max_new_tokens=10) for p in prompts]
    for _ in range(4):
        eng.step()
    state = eng.checkpoint()
    assert (state["prefill_pos"] > 0).any() and "block_table" not in state
    eng._release_state()
    assert eng.cache is None and eng.occupancy() == 0
    eng.restore(state)
    eng.run_until_drained()
    assert [r.tokens for r in reqs] == want
    # the snapshot was not aliased: it still restores the mid-run state
    eng.restore(state)
    assert eng.occupancy() == 2


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_monitoring_api_matches_jax(params, layout):
    """occupancy(), pages_in_use() and admission_signals() read what the
    JAX engine's do, queued and mid-run, on both layouts."""
    jp, tp = params
    prompts = [np.random.default_rng(5).integers(1, CFG.vocab_size, n).astype(np.int32)
               for n in (6, 9, 4)]
    kw = dict(max_slots=2, max_len=32, page_size=8, kv_layout=layout)
    engines = [JEngine(JCFG, params=jp, **kw), _engine(tp, **kw)]
    for eng in engines:
        for p in prompts:
            eng.submit(p, max_new_tokens=3)
    signals = [[], []]
    for _ in range(2):
        for i, eng in enumerate(engines):
            sig = eng.admission_signals()
            assert sig["oldest_queued_age_s"] >= 0.0
            sig.pop("oldest_queued_age_s")
            sig.pop("engine")
            signals[i].append((sig, eng.occupancy(), eng.pages_in_use()))
            eng.step()
    assert signals[0] == signals[1]
    assert signals[1][1][1] == 2  # two slots bound after the first step


def test_layout_arguments_are_checked(params):
    with pytest.raises(ValueError, match="kv_layout"):
        _engine(params[1], cfg=CFG, kv_layout="ring")
    with pytest.raises(ValueError, match="paged"):
        _engine(params[1], cfg=CFG, kv_layout="contiguous", prefill_only=True)


def test_prefill_without_chunk_lens_is_the_training_slice(params):
    """The training slice landed the prefill without chunk_lens: into an
    empty cache it writes the prompt at offset 0 and gives the no-cache
    forward's logits; over a warm cache it refuses (pass chunk_lens)."""
    tp = params[1]
    cache = map_tree(lambda p: torch.zeros(p.shape, dtype=p.dtype),
                     tlm.lm_cache_specs(CFG32, 1, 16))
    tok = torch.ones((1, 4), dtype=torch.int32)
    got, cache, _ = tlm.lm_apply(CFG32, tp, tok, None, cache,
                                 torch.tensor(0, dtype=torch.int32))
    want, _, _ = tlm.lm_apply(CFG32, tp, tok, remat=False)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert cache["unit"]["b0"]["k"][:, :4].abs().sum() > 0
    assert not cache["unit"]["b0"]["k"][:, 4:].any()
    with pytest.raises(NotImplementedError, match="chunk_lens"):
        tlm.lm_apply(CFG32, tp, tok, None, cache, torch.tensor(4, dtype=torch.int32))
