"""Port parity for the encoder-decoder (whisper-medium), on the CPU: every
function of ``repro_torch.models.encdec`` and the encoder-decoder branches
of ``attn_apply`` and the step factories against ``repro`` on shared
weights (JAX-initialised, carried across by ``from_jax_params``) and
numpy-seeded inputs, at whisper's smoke config in fp32 compute; the
spec and cache trees; the refusals both packages share; and JAX's
ragged-KV-chunk fault at the encoder's length.

Every parity test but the fault's keeps its KV lengths within one whole
KV chunk (``kv_chunk`` 1024, at most 64 frames), where JAX's
``chunked_attention`` is exact.

Tolerances (fp32): 2e-5 for blocks and functions, 1e-4 for whole
forwards, losses and decode streams (sums in other orders over many
layers)."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402
import math  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jcfg  # noqa: E402
import repro_torch.configs as tcfg  # noqa: E402
from repro.common.params import init_params as jinit  # noqa: E402
from repro.common.params import is_param as j_is_param  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import blocks as JB  # noqa: E402
from repro.models import encdec as JE  # noqa: E402
from repro.serve.engine import ServeEngine as JEngine  # noqa: E402
from repro.train import state as jstate  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch.common.params import from_jax_params, map_tree, tree_leaves  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import blocks as TB  # noqa: E402
from repro_torch.models import encdec as TE  # noqa: E402
from repro_torch.serve import ServeEngine as TEngine  # noqa: E402
from repro_torch.train import state as tstate  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

TOL = dict(atol=2e-5, rtol=2e-5)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = "whisper-medium"
B, FRAMES, T_DEC = 2, 64, 8


def _cfgs(**kw):
    """The smoke config in fp32 compute, in both packages."""
    return (dataclasses.replace(jcfg.get_config(ARCH, smoke=True), compute_dtype=jnp.float32,
                                **kw),
            tcfg.get_config(ARCH, smoke=True).with_overrides(compute_dtype=torch.float32, **kw))


JC, TC = _cfgs()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    jp = jinit(jax.random.PRNGKey(1), jstate.model_specs(JC))
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), "cpu")


def _x(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _tokens(seed, shape, vocab=JC.vocab_size):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **tol)


# -- functions -----------------------------------------------------------------


@pytest.mark.parametrize("S,d,atol", [
    (FRAMES, JC.d_model, 2e-5),
    # whisper-medium's encoder: angles up to 1499 rad, where one fp32 ulp
    # of the angle is 2^-13, so sin and cos may differ by two of those
    (1500, 1024, 2 * 2.0 ** -13)])
def test_sinusoid_matches(S, d, atol):
    got = TE._sinusoid(S, d)
    assert got.dtype == torch.float32 and got.shape == (S, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(JE._sinusoid(S, d)), atol=atol, rtol=0)


@pytest.mark.parametrize("remat", [False, True])
def test_encode_matches(params, remat):
    jp, tp = params
    fr = _x(0, (B, FRAMES, JC.d_model))
    want = JE.encode(JC, jp, jnp.asarray(fr), remat=remat)
    got = TE.encode(TC, tp, torch.from_numpy(fr), remat=remat)
    assert got.shape == (B, FRAMES, JC.d_model)
    _close(got, want, MODEL_TOL)


@pytest.mark.parametrize("last_only", [False, True])
def test_decode_train_matches(params, last_only):
    jp, tp = params
    enc = _x(1, (B, FRAMES, JC.d_model))
    tok = _tokens(2, (B, T_DEC))
    want = JE.decode_train(JC, jp, jnp.asarray(enc), jnp.asarray(tok), remat=False,
                           last_only=last_only)
    with torch.no_grad():
        got = TE.decode_train(TC, tp, torch.from_numpy(enc), torch.from_numpy(tok),
                              remat=False, last_only=last_only)
    assert got.shape == (B, 1 if last_only else T_DEC, JC.padded_vocab)
    _close(got, want, MODEL_TOL)


def test_precompute_cross_cache_matches(params):
    jp, tp = params
    enc = _x(3, (B, FRAMES, JC.d_model))
    want = JE.precompute_cross_cache(JC, jp, jnp.asarray(enc))
    got = TE.precompute_cross_cache(TC, tp, torch.from_numpy(enc))
    assert set(got["b0"]) == {"xk", "xv"}
    for name in ("xk", "xv"):
        assert got["b0"][name].shape == (JC.num_decoder_layers, B, FRAMES, JC.num_kv_heads,
                                         JC.head_dim)
        _close(got["b0"][name], want["b0"][name], TOL)


def _attn_case(kind):
    """x, positions and attn_apply's keywords of the encoder's full
    self-attention, the decoder's causal one and its cross-attention;
    positions start past 0 so that RoPE turns every row."""
    S = T_DEC if kind == "cross" else 12
    x = _x(10, (B, S, JC.d_model))
    pos = (np.arange(S, dtype=np.int32)[None] + np.array([[3], [40]], np.int32))
    kw = {"full": {"causal": False}, "causal": {"causal": True},
          "cross": {"causal": False, "kv_source": _x(11, (B, 24, JC.d_model))}}[kind]
    return x, pos, kw


@pytest.mark.parametrize("kind", ["full", "causal", "cross"])
def test_attn_apply_matches_and_ropes_causal_self_attention_only(params, kind):
    """Each kind against JAX; then the same call with every position
    times 5, which changes the distances between them (RoPE sees only
    those): the encoder's and the cross-attention's outputs must not move
    (RoPE applied everywhere would fail here), while the causal
    self-attention's must."""
    jp, tp = params
    jblk = jax.tree.map(lambda a: a[0], jp["dec_unit"]["b0"]["self"])
    tblk = map_tree(lambda t: t[0], tp["dec_unit"]["b0"]["self"])
    x, pos, kw = _attn_case(kind)
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    want, _ = JB.attn_apply(JC, jblk, jnp.asarray(x), jnp.asarray(pos), **jkw)
    got, none = TB.attn_apply(TC, tblk, torch.from_numpy(x), torch.from_numpy(pos), **tkw)
    assert none is None
    _close(got, want, TOL)
    moved, _ = TB.attn_apply(TC, tblk, torch.from_numpy(x), torch.from_numpy(pos * 5), **tkw)
    shift = (moved - got).abs().max().item()
    if kind == "causal":
        assert shift > 1e-3, shift
    else:
        assert shift == 0.0, shift


def _zero_cache(specs, lib):
    if lib is torch:
        return map_tree(lambda p: torch.zeros(p.shape, dtype=p.dtype), specs)
    return jax.tree.map(lambda p: jnp.zeros(p.shape, p.dtype), specs, is_leaf=j_is_param)


def _filled_caches(jp, tp, enc, max_len):
    """Both packages' decode caches: an empty self cache of ``max_len``,
    the cross K/V of ``enc`` precomputed."""
    n = enc.shape[1]
    jcache = _zero_cache(JE.encdec_cache_specs(JC, B, max_len, n), jnp)
    jx = JE.precompute_cross_cache(JC, jp, jnp.asarray(enc))
    jcache["dec_unit"]["b0"].update(jx["b0"])
    tcache = _zero_cache(TE.encdec_cache_specs(TC, B, max_len, n), torch)
    tx = TE.precompute_cross_cache(TC, tp, torch.from_numpy(enc))
    for name in ("xk", "xv"):
        tcache["dec_unit"]["b0"][name].copy_(tx["b0"][name])
    return jcache, tcache


def test_decode_step_matches_over_16_steps(params):
    """16 greedy steps from a start token over an empty self cache and the
    precomputed cross cache, through both packages' decode steps: logits
    at every step, the streams, and the final caches."""
    jp, tp = params
    enc = _x(4, (B, FRAMES, JC.d_model))
    jcache, tcache = _filled_caches(jp, tp, enc, 24)
    jdec, tdec = jax.jit(jstep.make_decode_step(JC)), tstep.make_decode_step(TC)
    start = _tokens(5, (B, 1))
    jtok, ttok = jnp.asarray(start), torch.from_numpy(start)
    js, ts = [], []
    for i in range(16):
        jn, jl, jcache = jdec(jp, jtok, jcache, jnp.asarray(i, jnp.int32))
        with torch.no_grad():
            tn, tl, tcache = tdec(tp, ttok, tcache, i)
        _close(tl, jl, MODEL_TOL)
        js.append(np.asarray(jn))
        ts.append(tn.numpy())
        jtok, ttok = jn[:, None], tn[:, None]
    np.testing.assert_array_equal(np.stack(ts), np.stack(js))
    for name in ("k", "v", "xk", "xv"):
        _close(tcache["dec_unit"]["b0"][name], jcache["dec_unit"]["b0"][name], MODEL_TOL)


def test_no_cache_prefill_equals_decode_replay(params):
    """JAX's teacher-forced == step-by-step invariant, in the port: the
    no-cache prefill step's last logits over T tokens equal the decode
    replay's at position T - 1; JAX's prefill step gives the same."""
    jp, tp = params
    fr = _x(6, (B, FRAMES, JC.d_model))
    tok = _tokens(7, (B, 12))
    last = tstep.make_prefill_step(TC)(tp, {"frames": torch.from_numpy(fr),
                                            "tokens": torch.from_numpy(tok)})
    jlast = jstep.make_prefill_step(JC)(jp, {"frames": jnp.asarray(fr),
                                             "tokens": jnp.asarray(tok)})
    _close(last, jlast, MODEL_TOL)
    with torch.no_grad():
        enc = TE.encode(TC, tp, torch.from_numpy(fr), remat=False)
    _, tcache = _filled_caches(jp, tp, enc.numpy(), 16)
    dec = tstep.make_decode_step(TC)
    with torch.no_grad():
        for i in range(tok.shape[1]):
            _, lg, tcache = dec(tp, torch.from_numpy(tok[:, i:i + 1]), tcache, i)
    _close(lg[:, 0], last.numpy(), MODEL_TOL)


def test_three_train_steps_match():
    """Three AdamW steps under remat on the frames / tokens / labels
    batch: loss and grad-norm within 1e-4 relative at every step, and the
    parameters after them within the model tolerance."""
    run = jcfg.RunConfig()
    js = jstate.init_train_state(jax.random.PRNGKey(0), JC, run)
    ts = from_jax_params(jax.tree.map(np.asarray, js), "cpu")
    jfn = jax.jit(jstep.make_train_step(JC, run))
    tfn = tstep.make_train_step(TC, tcfg.RunConfig())
    for i in range(3):
        fr = _x(20 + i, (B, FRAMES, JC.d_model))
        tok = _tokens(30 + i, (B, T_DEC))
        lab = np.roll(tok, -1, axis=1)
        js, jm = jfn(js, {"frames": jnp.asarray(fr), "tokens": jnp.asarray(tok),
                          "labels": jnp.asarray(lab)})
        ts, tm = tfn(ts, {"frames": torch.from_numpy(fr), "tokens": torch.from_numpy(tok),
                          "labels": torch.from_numpy(lab)})
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-4)
    jleaves = jax.tree.leaves(js["params"])
    tleaves = tree_leaves(ts["params"])
    assert len(jleaves) == len(tleaves)
    for t, j in zip(tleaves, jleaves):
        _close(t, j, MODEL_TOL)


def test_loss_and_grads_match(params):
    """One loss and its gradient, leaf by leaf, under remat."""
    jp, tp = params
    fr = _x(8, (B, FRAMES, JC.d_model))
    tok = _tokens(9, (B, T_DEC))
    lab = np.roll(tok, -1, axis=1)
    jbatch = {"frames": jnp.asarray(fr), "tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)}
    jl, jg = jax.value_and_grad(jstep.make_loss_fn(JC, jcfg.RunConfig()))(jp, jbatch)
    leaves = [t.detach().requires_grad_() for t in tree_leaves(tp)]
    it = iter(leaves)
    tree = map_tree(lambda _: next(it), tp)
    loss = tstep.make_loss_fn(TC, tcfg.RunConfig())(
        tree, {"frames": torch.from_numpy(fr), "tokens": torch.from_numpy(tok),
               "labels": torch.from_numpy(lab)})
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-4)
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(grads)
    for t, j in zip(grads, jleaves):
        _close(t, j, MODEL_TOL)


# -- trees -------------------------------------------------------------------


def _shapes(tree, is_leaf):
    if isinstance(tree, dict):
        return {k: _shapes(v, is_leaf) for k, v in tree.items()}
    assert is_leaf(tree)
    dt = tree.dtype
    name = str(dt).removeprefix("torch.") if isinstance(dt, torch.dtype) else np.dtype(dt).name
    return tuple(tree.shape), name, tree.init


@pytest.mark.parametrize("smoke", [False, True])
def test_spec_and_cache_trees_match(smoke):
    """Parameters and the decode cache, shape, dtype and init, key for
    key; the cross cache holds 1500 positions whatever max_len is."""
    j, t = jcfg.get_config(ARCH, smoke=smoke), tcfg.get_config(ARCH, smoke=smoke)
    assert _shapes(tstate.model_specs(t), lambda x: True) == \
        _shapes(jstate.model_specs(j), j_is_param)
    for max_len in (20, 448, 4096):
        tc = tstate.cache_specs(t, 3, max_len)
        assert _shapes(tc, lambda x: True) == _shapes(jstate.cache_specs(j, 3, max_len),
                                                      j_is_param)
        b0 = tc["dec_unit"]["b0"]
        assert b0["k"].shape[2] == max_len and b0["xk"].shape[2] == tstate.ENC_LEN == 1500
    if not smoke:
        n = sum(math.prod(p.shape) for p in tree_leaves(tstate.model_specs(t)))
        assert 0.80e9 < n < 0.82e9, n


# -- what stays refused ------------------------------------------------------


def _message(call, exc=NotImplementedError):
    with pytest.raises(exc) as info:
        call()
    return str(info.value)


def test_refusals_are_jaxs():
    """The engine (both layouts), the serve driver and both cache-writing
    prefills refuse the encoder-decoder with JAX's words."""
    j, t = jcfg.get_config(ARCH, smoke=True), tcfg.get_config(ARCH, smoke=True)
    pairs = {
        "chunked_prefill": (lambda: jstep.make_prefill_chunk_step(j),
                            lambda: tstep.make_prefill_chunk_step(t)),
        "prefill_with_cache": (lambda: jstep.make_prefill_step(j, with_cache=True, max_len=32),
                               lambda: tstep.make_prefill_step(t, with_cache=True, max_len=32)),
    }
    for layout in ("paged", "contiguous"):
        pairs[f"engine_{layout}"] = (
            lambda layout=layout: JEngine(j, kv_layout=layout, max_len=32),
            lambda layout=layout: TEngine(t, kv_layout=layout, max_len=32, device="cpu"))
    for name, (jcall, tcall) in pairs.items():
        want = _message(jcall)
        assert _message(tcall) == want, name
        assert "queue 1" not in want
    argv = ["--arch", ARCH, "--smoke"]
    want = _message(lambda: jserve.run(jserve.build_parser().parse_args(argv)), SystemExit)
    got = _message(lambda: tserve.run(tserve.build_parser().parse_args(argv + ["--device", "cpu"])),
                   SystemExit)
    assert got == want == "serve driver targets token-LM archs"


# -- the reference's fault ---------------------------------------------------


def test_reference_fault_ragged_kv_chunk_at_the_encoder_length(params):
    """40 frames with ``kv_chunk`` 16: JAX's ``chunked_attention`` shifts
    its last KV chunk back over keys it already counted, so JAX's
    ``encode`` (and ``decode_train``'s cross-attention) compute another
    function than the one they describe.  The port's equal the exact
    softmax: JAX's own with one whole KV chunk (``kv_chunk`` >= 40).
    (ROADMAP.md queue 3.)"""
    jp, tp = params
    jc16, tc16 = _cfgs(kv_chunk=16)
    fr = _x(12, (B, 40, JC.d_model))
    tok = _tokens(13, (B, T_DEC))
    exact = JE.encode(JC, jp, jnp.asarray(fr), remat=False)
    faulty = JE.encode(jc16, jp, jnp.asarray(fr), remat=False)
    with torch.no_grad():
        got = TE.encode(tc16, tp, torch.from_numpy(fr), remat=False)
    _close(got, exact, MODEL_TOL)
    assert np.abs(np.asarray(faulty) - np.asarray(exact)).max() > 0.05
    exact_l = JE.decode_train(JC, jp, exact, jnp.asarray(tok), remat=False)
    faulty_l = JE.decode_train(jc16, jp, exact, jnp.asarray(tok), remat=False)
    with torch.no_grad():
        got_l = TE.decode_train(tc16, tp, torch.from_numpy(np.array(exact)),
                                torch.from_numpy(tok), remat=False)
    _close(got_l, exact_l, MODEL_TOL)
    assert np.abs(np.asarray(faulty_l) - np.asarray(exact_l)).max() > 0.05
