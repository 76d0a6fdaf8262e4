"""Port parity for windowed (local) attention, on the CPU: every branch of
``attn_apply`` with a window against ``repro.models.blocks.attn_apply``
on recurrentgemma's smoke config (window 16) in fp32, on shared weights
and numpy-seeded inputs: the no-cache forward, the ring prefill into an
empty cache shorter and longer than the ring, and the scalar and [B]
ring decodes through a wrap; the port's windowed chunked attention
against a band mask; and the refusals both packages share.

The JAX side's ``chunked_attention`` runs at sequence lengths its chunks
count correctly (each a multiple of the KV chunk, or under one chunk):
its ragged last chunk is a recorded fault of the reference
(``tests/test_torch_flash.py``).  Tolerance 2e-5 (fp32; the repo's
kernel tolerance): the same attention summed in another order."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jcfg  # noqa: E402
import repro_torch.configs as tcfg  # noqa: E402
from repro.common.params import init_params as jinit  # noqa: E402
from repro.models import blocks as jb  # noqa: E402
from repro_torch.common.params import from_jax_params  # noqa: E402
from repro_torch.models import blocks as tb  # noqa: E402

TOL = dict(atol=2e-5, rtol=2e-5)
JCFG = dataclasses.replace(jcfg.get_config("recurrentgemma-9b", smoke=True),
                           compute_dtype=jnp.float32)
TCFG = tcfg.get_config("recurrentgemma-9b", smoke=True).with_overrides(
    compute_dtype=torch.float32)
W = JCFG.window  # 16
_, KV = JCFG.padded_gqa()
D = JCFG.head_dim


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    jp = jinit(jax.random.PRNGKey(0), jb.attn_specs(JCFG))
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), "cpu")


def _x(seed, B, S):
    return (np.random.default_rng(seed).standard_normal((B, S, JCFG.d_model))
            * 0.5).astype(np.float32)


def _pos(B, S, base=0):
    return np.broadcast_to(base + np.arange(S, dtype=np.int32), (B, S)).copy()


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want, np.float32), **TOL)


@pytest.mark.parametrize("S,chunk", [(12, 1024), (64, 1024), (64, 16)])
def test_no_cache_windowed_attention_matches(params, S, chunk):
    """Shorter than the window, longer (one chunk), and in 16-position
    chunks, where whole KV chunks fall out of the window."""
    jp, tp = params
    jc = dataclasses.replace(JCFG, q_chunk=chunk, kv_chunk=chunk)
    tc = TCFG.with_overrides(q_chunk=chunk, kv_chunk=chunk)
    x, pos = _x(1, 2, S), _pos(2, S)
    want, _ = jb.attn_apply(jc, jp, jnp.asarray(x), jnp.asarray(pos), window=W)
    got, cache = tb.attn_apply(tc, tp, torch.from_numpy(x), torch.from_numpy(pos), window=W)
    assert cache is None
    _close(got, want)


def _caches(B, slots):
    return ({"k": jnp.zeros((B, slots, KV, D)), "v": jnp.zeros((B, slots, KV, D)), "len": 0},
            {"k": torch.zeros(B, slots, KV, D), "v": torch.zeros(B, slots, KV, D), "len": 0})


@pytest.mark.parametrize("S", [10, 16, 40])
def test_ring_prefill_matches(params, S):
    """A prefill into an empty ring of 16 slots: shorter than the ring
    (written at the front), as long, and longer (the last 16 positions
    kept, each at its position mod 16)."""
    jp, tp = params
    B = 2
    jcache, tcache = _caches(B, W)
    x, pos = _x(2, B, S), _pos(B, S)
    want, jnew = jb.attn_apply(JCFG, jp, jnp.asarray(x), jnp.asarray(pos), jcache, window=W)
    got, tnew = tb.attn_apply(TCFG, tp, torch.from_numpy(x), torch.from_numpy(pos), tcache,
                              window=W)
    _close(got, want)
    for key in ("k", "v"):
        _close(tnew[key], jnew[key])
        assert tnew[key] is tcache[key]  # written in place
    assert int(tnew["len"]) == int(jnew["len"]) == S


@pytest.mark.parametrize("per_slot", [False, True])
def test_ring_decode_through_a_wrap_matches(params, per_slot):
    """A 10-token ring prefill, then 30 decode steps (positions 10-39:
    the ring of 16 wraps at 16 and at 32), scalar or [B] lengths; each
    step's output and the ring after it."""
    jp, tp = params
    B, S0 = 2, 10
    jcache, tcache = _caches(B, W)
    x0 = _x(3, B, S0)
    _, jcache = jb.attn_apply(JCFG, jp, jnp.asarray(x0), jnp.asarray(_pos(B, S0)), jcache,
                              window=W)
    _, tcache = tb.attn_apply(TCFG, tp, torch.from_numpy(x0), torch.from_numpy(_pos(B, S0)),
                              tcache, window=W)
    xs = _x(4, B, 30)
    for i in range(30):
        p = S0 + i
        jlen = jnp.full((B,), p, jnp.int32) if per_slot else jnp.asarray(p, jnp.int32)
        tlen = torch.full((B,), p, dtype=torch.int32) if per_slot else torch.tensor(p)
        jcache = {**jcache, "len": jlen}
        tcache = {**tcache, "len": tlen}
        pos = _pos(B, 1, p)
        want, jcache = jb.attn_apply(JCFG, jp, jnp.asarray(xs[:, i:i + 1]), jnp.asarray(pos),
                                     jcache, window=W)
        got, tcache = tb.attn_apply(TCFG, tp, torch.from_numpy(xs[:, i:i + 1]),
                                    torch.from_numpy(pos), tcache, window=W)
        _close(got, want)
        _close(tcache["k"], jcache["k"])
        _close(tcache["v"], jcache["v"])
        np.testing.assert_array_equal(tcache["len"].numpy(), np.asarray(jcache["len"]))


def test_port_windowed_chunked_attention_is_a_band_mask():
    """The port's mirror of tests/test_recurrent_consistency.py::
    test_local_attention_window_masking."""
    rng = np.random.default_rng(6)
    S, H = 64, 4
    q, k, v = (torch.from_numpy(rng.standard_normal((1, S, H, D)).astype(np.float32))
               for _ in range(3))
    got = tb.chunked_attention(q, k, v, causal=True, window=W, q_chunk=16, kv_chunk=16)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(D)
    pos = torch.arange(S)
    mask = (pos[:, None] >= pos[None, :]) & ((pos[:, None] - pos[None, :]) < W)
    s = torch.where(mask[None, None], s, -1e30)
    want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4, rtol=1e-4)


def _message(call):
    with pytest.raises(NotImplementedError) as info:
        call()
    return str(info.value)


def test_windowed_refusals_are_jaxs(params):
    """A window over a paged cache, and a window under the ragged chunked
    prefill, refuse with JAX's words."""
    jp, tp = params
    B, T = 2, 4
    x, pos = _x(5, B, T), _pos(B, T)
    jpaged = {"k_pages": jnp.zeros((4, 16, KV, D)), "v_pages": jnp.zeros((4, 16, KV, D)),
              "block_table": jnp.zeros((B, 2), jnp.int32), "len": jnp.zeros((B,), jnp.int32)}
    tpaged = {"k_pages": torch.zeros(4, 16, KV, D), "v_pages": torch.zeros(4, 16, KV, D),
              "block_table": torch.zeros(B, 2, dtype=torch.int32),
              "len": torch.zeros(B, dtype=torch.int32)}
    jring, tring = _caches(B, W)
    jring["len"] = jnp.zeros((B,), jnp.int32)
    tring["len"] = torch.zeros(B, dtype=torch.int32)
    clens = np.full((B,), T, np.int32)
    for jc, tc, kw in ((jpaged, tpaged, {}),
                       (jring, tring, {"chunk_lens": clens})):
        want = _message(lambda: jb.attn_apply(
            JCFG, jp, jnp.asarray(x), jnp.asarray(pos), jc, window=W,
            **{k: jnp.asarray(a) for k, a in kw.items()}))
        got = _message(lambda: tb.attn_apply(
            TCFG, tp, torch.from_numpy(x), torch.from_numpy(pos), tc, window=W,
            **{k: torch.from_numpy(a) for k, a in kw.items()}))
        assert got == want
