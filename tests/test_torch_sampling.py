"""Port parity for seeded sampling: threefry2x32's ``split`` and random
bits bitwise against ``jax.random`` (partitionable threefry, as this JAX
sets it) for many seeds, seeds >= 2^32 among them; the uniforms bitwise;
the gumbel logs within one ulp; ``sample_tokens``' tokens and advanced
keys equal to JAX's; the ServeEngine's seeded streams equal to the JAX
engine's on every served family and both layouts (the mirrors of
tests/test_serving.py's sampling tests); and ``reset_stats``."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.common.params import init_params  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.serve.sampling import make_slot_key as j_make_slot_key  # noqa: E402
from repro.serve.sampling import sample_tokens as j_sample_tokens  # noqa: E402
from repro.train.state import model_specs  # noqa: E402
from repro_torch.common.params import from_jax_params  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.serve import RequestState, ServeEngine  # noqa: E402
from repro_torch.serve import sampling as ts  # noqa: E402

TINY = float(np.finfo(np.float32).tiny)
# seeds across the key's two words: small, around 2^31 and 2^32, large
SEED_GROUPS = {
    "small": list(range(16)),
    "word_edges": [2**31 - 1, 2**31, 2**32 - 1, 2**32, 2**32 + 1, 2**33 + 7],
    "large": [int(s) for s in np.random.default_rng(0).integers(2**32, 2**63 - 1, 24,
                                                                  dtype=np.int64)]
    + [2**63 - 1],
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # the CPU is shared with the other test workers: torch's intra-op pool
    # only contends for it at these sizes
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _keys(seeds):
    keys = np.stack([ts.make_slot_key(s) for s in seeds])
    return keys, torch.from_numpy(keys.astype(np.int64))


def test_threefry_is_partitionable_in_this_jax():
    """The port mirrors the partitionable split and bits; the JAX default
    must be the one it mirrors."""
    assert jax.config.jax_threefry_partitionable


def test_make_slot_key_matches_jax():
    for s in [x for group in SEED_GROUPS.values() for x in group]:
        np.testing.assert_array_equal(ts.make_slot_key(s), j_make_slot_key(s))
        if s < 2**32:  # PRNGKey keeps a seed's low 32 bits without x64
            np.testing.assert_array_equal(ts.make_slot_key(s),
                                          np.asarray(jax.random.PRNGKey(s)))


@pytest.mark.parametrize("group", sorted(SEED_GROUPS))
def test_split_and_bits_are_bitwise_jax(group):
    keys, tkeys = _keys(SEED_GROUPS[group])
    jk = jnp.asarray(keys)
    want = np.asarray(jax.vmap(lambda k: jax.random.split(k, 2))(jk))
    np.testing.assert_array_equal(ts.split(tkeys, 2).numpy().astype(np.uint32), want)
    want = np.asarray(jax.vmap(lambda k: jax.random.split(k, 5))(jk))
    np.testing.assert_array_equal(ts.split(tkeys, 5).numpy().astype(np.uint32), want)
    n = 1001  # odd: no pairing of counters
    want = np.asarray(jax.vmap(lambda k: jax.random.bits(k, (n,), jnp.uint32))(jk))
    np.testing.assert_array_equal(ts.random_bits(tkeys, n).numpy().astype(np.uint32), want)
    for lo in (0.0, TINY):
        want = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (n,), minval=lo))(jk))
        got = ts.uniform(tkeys, n, lo, 1.0).numpy()
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


def test_gumbel_logs_are_within_one_ulp():
    """-log(-log(u)): the uniforms are bitwise, each log of torch and of
    XLA differs by at most one ulp on the same input, so the gumbels
    differ by at most the inner ulp carried through the outer log
    (2^-23 relative to 1, one ulp of log u over |log u|) plus one ulp of
    the result."""
    keys, tkeys = _keys(SEED_GROUPS["small"][:4])
    n = 50_000
    u = ts.uniform(tkeys, n, TINY, 1.0)
    inner_t = torch.log(u).numpy()
    inner_j = np.asarray(jnp.log(jnp.asarray(u.numpy())))
    assert _ulps(inner_t, inner_j).max() <= 1
    outer_t = torch.log(torch.from_numpy(-inner_j)).numpy()
    outer_j = np.asarray(jnp.log(jnp.asarray(-inner_j)))
    assert _ulps(outer_t, outer_j).max() <= 1
    want = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (n,)))(jnp.asarray(keys)))
    got = ts.gumbel(tkeys, n).numpy()
    assert np.all(np.abs(got - want) <= 2.0 ** -23 + np.spacing(np.abs(want)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_tokens_match_jax(seed):
    """Rows of mixed temperature (greedy among them) and top-k (none, 1,
    a few, the whole vocabulary): the same tokens and advanced keys."""
    rng = np.random.default_rng(seed)
    B, V = 8, 257
    logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    keys, tkeys = _keys([int(s) for s in rng.integers(0, 2**40, B)])
    temp = np.array([0.0, 0.5, 1.0, 2.0, 1.0, 0.7, 3.0, 0.0], np.float32)
    topk = np.array([0, 0, 5, 1, V, 0, 3, 4], np.int32)
    jt, jk = j_sample_tokens(jnp.asarray(logits), jnp.asarray(keys), jnp.asarray(temp),
                             jnp.asarray(topk))
    tt, tk = ts.sample_tokens(torch.from_numpy(logits), tkeys, torch.from_numpy(temp),
                              torch.from_numpy(topk))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tk.numpy().astype(np.uint32), np.asarray(jk))
    assert tt.dtype == torch.int32


# -- the engine ----------------------------------------------------------------


ARCHS = ["tinyllama-1.1b", "minicpm3-4b", "moonshot-v1-16b-a3b"]


def _pair(arch):
    jc = dataclasses.replace(jget(arch, smoke=True), compute_dtype=jnp.float32)
    tc = tget(arch, smoke=True).with_overrides(compute_dtype=torch.float32)
    jp = init_params(jax.random.PRNGKey(0), model_specs(jc))
    return jc, tc, jp, from_jax_params(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def tiny():
    return _pair("tinyllama-1.1b")


def _engines(pair, **kw):
    jc, tc, jp, tp = pair
    return (JEngine(jc, params=jp, **kw),
            ServeEngine(tc, params=tp, device="cpu", **kw))


def _both(engines, prompt, **kw):
    return [e.submit(prompt, **kw) for e in engines]


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
@pytest.mark.parametrize("arch", ARCHS)
def test_sampled_streams_match_jax_engine(arch, layout):
    """Requests of mixed temperature, top-k and seeds (one greedy, one
    seed >= 2^32) share the fused batch: every stream equals the JAX
    engine's, token for token."""
    engines = _engines(_pair(arch), max_slots=4, max_len=64, kv_layout=layout)
    rng = np.random.default_rng(3)
    reqs = []
    for i, (temp, k, seed) in enumerate([(1.0, 0, 5), (0.0, 0, 0), (0.8, 8, 2**32 + 9),
                                         (2.0, 0, 11), (1.3, 3, 12)]):
        prompt = rng.integers(1, 250, 4 + 3 * i).astype(np.int32)
        reqs.append(_both(engines, prompt, max_new_tokens=10, temperature=temp, top_k=k,
                          seed=seed))
    for e in engines:
        e.run_until_drained()
    for jr, tr in reqs:
        assert tr.state is RequestState.DONE
        assert tr.tokens == jr.tokens


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_sampling_seeded_reproducible(tiny, layout):
    """Same seed -> same stream, different seed -> different (at
    temperature 2 over a 256-token vocabulary), and the JAX engine's
    streams."""
    engines = _engines(tiny, max_slots=2, max_len=64, kv_layout=layout)
    prompt = np.arange(1, 7, dtype=np.int32)
    a, b, c = (_both(engines, prompt, max_new_tokens=12, temperature=2.0, seed=s)
               for s in (123, 123, 124))
    for e in engines:
        e.run_until_drained()
    assert a[1].tokens == b[1].tokens
    assert a[1].tokens != c[1].tokens
    assert [r[1].tokens for r in (a, b, c)] == [r[0].tokens for r in (a, b, c)]


def test_sampling_does_not_perturb_greedy_neighbors(tiny):
    """A sampling neighbour in the fused batch leaves a greedy stream as it
    is alone."""
    jc, tc, jp, tp = tiny
    rng = np.random.default_rng(13)
    prompt = rng.integers(1, 250, 6).astype(np.int32)
    alone = ServeEngine(tc, params=tp, device="cpu", max_slots=2, max_len=64)
    want = alone.submit(prompt, max_new_tokens=8)
    alone.run_until_drained()
    engines = _engines(tiny, max_slots=2, max_len=64)
    greedy = _both(engines, prompt, max_new_tokens=8)
    _both(engines, rng.integers(1, 250, 5).astype(np.int32), max_new_tokens=8,
          temperature=1.5, seed=7)
    for e in engines:
        e.run_until_drained()
    assert greedy[1].tokens == want.tokens == greedy[0].tokens


def test_sampling_top_k_one_is_argmax(tiny):
    """top_k=1 collapses sampling to the argmax whatever the temperature."""
    jc, tc, jp, tp = tiny
    prompt = np.arange(1, 8, dtype=np.int32)
    eng = ServeEngine(tc, params=tp, device="cpu", max_slots=1, max_len=64)
    greedy = eng.submit(prompt, max_new_tokens=10)
    eng.run_until_drained()
    topk1 = eng.submit(prompt, max_new_tokens=10, temperature=3.0, top_k=1, seed=99)
    eng.run_until_drained()
    assert topk1.tokens == greedy.tokens


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_sampling_stream_survives_preemption(tiny, layout):
    """The per-slot keys ride the checkpoint: a stream checkpointed,
    released and restored mid-decode equals the uninterrupted one, and the
    JAX engine's."""
    jc, tc, jp, tp = tiny
    prompt = np.arange(1, 8, dtype=np.int32)
    jeng = JEngine(jc, params=jp, max_slots=2, max_len=64, kv_layout=layout)
    want = jeng.submit(prompt, max_new_tokens=12, temperature=1.0, seed=42)
    jeng.run_until_drained()
    eng = ServeEngine(tc, params=tp, device="cpu", max_slots=2, max_len=64,
                      kv_layout=layout)
    req = eng.submit(prompt, max_new_tokens=12, temperature=1.0, seed=42)
    for _ in range(5):
        eng.step()
    state = eng.checkpoint()
    assert state["slot_keys"].dtype == np.uint32 and state["slot_keys"].any()
    eng._release_state()
    eng.restore(state)
    eng.run_until_drained()
    assert req.state is RequestState.DONE
    assert req.tokens == want.tokens


def test_reset_stats(tiny):
    """reset_stats zeroes the counters and the derived figures, and the
    engine goes on counting from zero; the JAX engine's keys come back,
    with the port's own slab counter beside them."""
    engines = _engines(tiny, max_slots=2, max_len=64)
    for e in engines:
        e.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=4)
        e.run_until_drained()
        assert e.stats()["tokens_generated"] == 3 and e.stats()["completed"] == 1
        e.reset_stats()
        s = e.stats()
        assert s.get("tokens_generated", 0) == 0 and s.get("decode_steps", 0) == 0
        assert s["slot_occupancy"] == 0.0 and s["kv_bytes_per_token"] == 0.0
        e.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=4)
        e.run_until_drained()
        assert e.stats()["tokens_generated"] == 3
    assert set(engines[1].stats()) == set(engines[0].stats()) | {"prefill_slab_positions"}
