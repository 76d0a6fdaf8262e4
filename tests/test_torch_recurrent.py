"""Port parity for the recurrent families, on the CPU: every function of
``repro_torch.models.recurrent`` against ``repro.models.recurrent`` on
shared weights (JAX-initialised, carried across key for key) and
numpy-seeded inputs; the port's own chunked == step-by-step checks
(the cases of ``tests/test_recurrent_consistency.py``); and the xlstm
and recurrentgemma smoke configs through ``lm_apply``, the decode step,
three train steps and the training driver, with the refusals both
packages share.

Tolerances (fp32): 2e-5 where the port keeps JAX's order of operations
(conv1d, the gate coefficients, the step functions, the cells); 1e-4
where a scan sums in another order (the RG-LRU's log-depth scan, the
mLSTM's chunked form, the sLSTM's loop, whole blocks and models over a
sequence), JAX's own chunked-vs-sequential limit
(``tests/test_recurrent_consistency.py``)."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jcfg  # noqa: E402
import repro_torch.configs as tcfg  # noqa: E402
from repro.common.params import init_params as jinit  # noqa: E402
from repro.common.params import is_param as j_is_param  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import recurrent as JR  # noqa: E402
from repro.serve.engine import ServeEngine as JEngine  # noqa: E402
from repro.train import state as jstate  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch.common.params import from_jax_params, map_tree, tree_leaves  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import recurrent as TR  # noqa: E402
from repro_torch.serve import ServeEngine as TEngine  # noqa: E402
from repro_torch.train import state as tstate  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

# the order of operations kept: conv1d, coefficients, steps, cells
STEP_TOL = dict(atol=2e-5, rtol=2e-5)
# a scan summed in another order: JAX's chunked-vs-sequential limit
SCAN_TOL = dict(atol=1e-4, rtol=1e-4)
RECURRENT = ["recurrentgemma-9b", "xlstm-125m"]


def _cfgs(arch):
    """The smoke config in fp32 compute, in both packages."""
    return (dataclasses.replace(jcfg.get_config(arch, smoke=True), compute_dtype=jnp.float32),
            tcfg.get_config(arch, smoke=True).with_overrides(compute_dtype=torch.float32))


JG, TG = _cfgs("recurrentgemma-9b")
JX, TX = _cfgs("xlstm-125m")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _shared(specs, seed=0):
    """Block parameters initialised by JAX, and the same values in torch."""
    jp = jinit(jax.random.PRNGKey(seed), specs)
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), "cpu")


def _x(seed, shape, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **tol)


# -- conv1d, RG-LRU ----------------------------------------------------------


@pytest.mark.parametrize("with_state", [False, True])
def test_conv1d_matches(with_state):
    jp, tp = _shared(JR.conv1d_specs(4, 12))
    x = _x(0, (2, 7, 12))
    st = _x(1, (2, 3, 12)) if with_state else None
    jy, js = JR.conv1d_apply(jp, jnp.asarray(x), None if st is None else jnp.asarray(st))
    ty, ts = TR.conv1d_apply(tp, torch.from_numpy(x),
                             None if st is None else torch.from_numpy(st))
    _close(ty, jy, STEP_TOL)
    _close(ts, js, STEP_TOL)


def test_rglru_coeffs_and_step_match():
    jp, tp = _shared(JR.rglru_specs(JG))
    u = _x(2, (3, 1, JG.rnn_width), 2.0)
    for t, j in zip(TR._rglru_coeffs(tp, torch.from_numpy(u)),
                    JR._rglru_coeffs(jp, jnp.asarray(u), jnp.float32)):
        _close(t, j, STEP_TOL)
    h0 = _x(3, (3, JG.rnn_width))
    (to, th), (jo, jh) = (TR.rglru_step(tp, torch.from_numpy(u), torch.from_numpy(h0)),
                          JR.rglru_step(jp, jnp.asarray(u), jnp.asarray(h0)))
    _close(to, jo, STEP_TOL)
    _close(th, jh, STEP_TOL)
    assert th.dtype == torch.float32 and to.shape == (3, 1, JG.rnn_width)


def test_softplus_is_jaxs_past_torchs_threshold():
    x = torch.tensor([-30.0, 0.0, 19.0, 21.0, 40.0])
    np.testing.assert_allclose(TR._softplus(x).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x.numpy()))),
                               rtol=1e-7)


@pytest.mark.parametrize("S,chunk", [(64, 16), (64, 2048), (24, 16)])
def test_rglru_scan_matches(S, chunk):
    """Chunked (64 in chunks of 16: the carry crosses three boundaries),
    whole (one chunk), and a sequence under two chunks, scanned whole."""
    jp, tp = _shared(JR.rglru_specs(JG))
    u = _x(4, (2, S, JG.rnn_width))
    _close(TR.rglru_scan(tp, torch.from_numpy(u), chunk=chunk),
           JR.rglru_scan(jp, jnp.asarray(u), chunk=chunk), SCAN_TOL)


def test_chunked_scans_refuse_a_chunk_that_does_not_divide_s():
    """JAX reshapes into chunks, which fails unless the chunk divides S;
    the port raises the same TypeError rather than scan a ragged tail."""
    jp, tp = _shared(JR.rglru_specs(JG))
    u = _x(5, (1, 40, JG.rnn_width))
    with pytest.raises(TypeError):
        JR.rglru_scan(jp, jnp.asarray(u), chunk=16)
    with pytest.raises(TypeError, match="divide"):
        TR.rglru_scan(tp, torch.from_numpy(u), chunk=16)
    q = _x(6, (1, 20, 2, 8))
    with pytest.raises(TypeError):
        JR._mlstm_chunk_scan(*(jnp.asarray(q),) * 3, jnp.asarray(q[..., 0]),
                             jnp.asarray(q[..., 0]), 8)
    with pytest.raises(TypeError, match="divide"):
        TR._mlstm_chunk_scan(*(torch.from_numpy(q),) * 3, torch.from_numpy(q[..., 0]),
                             torch.from_numpy(q[..., 0]), 8)


def _replay(apply, jp, tp, cfg_j, cfg_t, x, jcache, tcache):
    """Both packages' blocks token by token from their caches: outputs per
    step within STEP_TOL, and the stacked outputs."""
    jo, to = [], []
    for t in range(x.shape[1]):
        jy, jcache = apply[0](cfg_j, jp, jnp.asarray(x[:, t:t + 1]), jcache)
        ty, tcache = apply[1](cfg_t, tp, torch.from_numpy(x[:, t:t + 1]), tcache)
        _close(ty, jy, STEP_TOL)
        jo.append(np.asarray(jy[:, 0]))
        to.append(_np(ty[:, 0]))
    return np.stack(jo, 1), np.stack(to, 1), jcache, tcache


def test_rglru_block_matches_full_and_cached():
    jp, tp = _shared(JR.rglru_specs(JG))
    x = _x(7, (2, 32, JG.d_model))
    jy, _ = JR.rglru_block_apply(JG, jp, jnp.asarray(x))
    ty, tc = TR.rglru_block_apply(TG, tp, torch.from_numpy(x))
    _close(ty, jy, SCAN_TOL)
    assert tc is None
    B, r, w = 2, JG.rnn_width, JG.conv_width
    jcache = {"conv": jnp.zeros((B, w - 1, r)), "h": jnp.zeros((B, r))}
    tcache = {"conv": torch.zeros(B, w - 1, r), "h": torch.zeros(B, r)}
    tensors = dict(tcache)
    *_, jcache, tcache = _replay((JR.rglru_block_apply, TR.rglru_block_apply), jp, tp,
                                 JG, TG, x, jcache, tcache)
    for key in ("conv", "h"):  # written in place, equal to JAX's new state
        assert tcache[key] is tensors[key]
        _close(tcache[key], jcache[key], SCAN_TOL)


# -- mLSTM -------------------------------------------------------------------


def _mlstm_inputs(seed, B=2, S=64, nh=2, dh=16):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, S, nh, dh)).astype(np.float32) * 0.3 for _ in range(3))
    log_i = rng.standard_normal((B, S, nh)).astype(np.float32) * 0.5
    log_f = np.array(jax.nn.log_sigmoid(
        jnp.asarray(rng.standard_normal((B, S, nh)).astype(np.float32) + 1.0)))
    return q, k, v, log_i, log_f


def test_mlstm_chunk_scan_and_step_match():
    args = _mlstm_inputs(8)
    _close(TR._mlstm_chunk_scan(*map(torch.from_numpy, args), 16),
           JR._mlstm_chunk_scan(*map(jnp.asarray, args), 16), SCAN_TOL)
    B, _, nh, dh = args[0].shape
    rng = np.random.default_rng(9)
    state = (rng.standard_normal((B, nh, dh, dh)).astype(np.float32) * 0.1,
             rng.standard_normal((B, nh, dh)).astype(np.float32) * 0.1,
             rng.standard_normal((B, nh)).astype(np.float32))
    one = [a[:, :1] for a in args]
    th, tstate_ = TR.mlstm_step(*map(torch.from_numpy, one), tuple(map(torch.from_numpy, state)))
    jh, jstate_ = JR.mlstm_step(*map(jnp.asarray, one), tuple(map(jnp.asarray, state)))
    _close(th, jh, STEP_TOL)
    for t, j in zip(tstate_, jstate_):
        _close(t, j, STEP_TOL)


def _mlstm_cache(B, cfg, lib):
    m = 2 * cfg.d_model
    nh = cfg.num_heads
    dh = m // nh
    z = jnp.zeros if lib is jnp else torch.zeros
    m0 = (jnp.full((B, nh), -1e30) if lib is jnp else torch.full((B, nh), -1e30))
    return {"conv": z((B, cfg.conv_width - 1, m)),
            "state": (z((B, nh, dh, dh)), z((B, nh, dh)), m0)}


def test_mlstm_block_matches_full_and_cached():
    jp, tp = _shared(JR.mlstm_specs(JX))
    x = _x(10, (2, 16, JX.d_model))
    _close(TR.mlstm_block_apply(TX, tp, torch.from_numpy(x), chunk=8)[0],
           JR.mlstm_block_apply(JX, jp, jnp.asarray(x), chunk=8)[0], SCAN_TOL)
    *_, jc, tc = _replay((JR.mlstm_block_apply, TR.mlstm_block_apply), jp, tp, JX, TX, x,
                         _mlstm_cache(2, JX, jnp), _mlstm_cache(2, TX, torch))
    for t, j in zip(tc["state"], jc["state"]):
        _close(t, j, SCAN_TOL)


# -- sLSTM -------------------------------------------------------------------


def test_slstm_cell_matches():
    jp, tp = _shared(JR.slstm_specs(JX))
    d, nh = JX.d_model, JX.num_heads
    xs = [_x(11 + i, (3, d), 1.0) for i in range(4)]
    rng = np.random.default_rng(15)
    state = (rng.standard_normal((3, d)).astype(np.float32),
             np.abs(rng.standard_normal((3, d))).astype(np.float32) + 0.5,
             rng.standard_normal((3, d)).astype(np.float32),
             rng.standard_normal((3, d)).astype(np.float32))
    got = TR._slstm_cell(tp, *map(torch.from_numpy, xs), tuple(map(torch.from_numpy, state)),
                         nh, d // nh)
    want = JR._slstm_cell(jp, *map(jnp.asarray, xs), tuple(map(jnp.asarray, state)),
                          nh, d // nh)
    for t, j in zip(got, want):
        _close(t, j, STEP_TOL)


def test_slstm_block_matches_full_and_cached():
    jp, tp = _shared(JR.slstm_specs(JX))
    x = _x(16, (2, 16, JX.d_model))
    _close(TR.slstm_block_apply(TX, tp, torch.from_numpy(x))[0],
           JR.slstm_block_apply(JX, jp, jnp.asarray(x))[0], SCAN_TOL)
    d = JX.d_model
    jc = {"state": tuple(jnp.zeros((2, d)) if i != 3 else jnp.full((2, d), -1e30)
                         for i in range(4))}
    tc = {"state": tuple(torch.zeros(2, d) if i != 3 else torch.full((2, d), -1e30)
                         for i in range(4))}
    *_, jc, tc = _replay((JR.slstm_block_apply, TR.slstm_block_apply), jp, tp, JX, TX, x,
                         jc, tc)
    for t, j in zip(tc["state"], jc["state"]):
        _close(t, j, SCAN_TOL)


# -- the port's own consistency (tests/test_recurrent_consistency.py) -------


def _port_params(specs, seed=0):
    from repro_torch.common.params import init_params

    return init_params(torch.Generator().manual_seed(seed), specs, "cpu")


def test_port_rglru_chunked_vs_sequential():
    p = _port_params(TR.rglru_specs(TG))
    u = torch.from_numpy(_x(20, (2, 64, TG.rnn_width)))
    h_chunked = TR.rglru_scan(p, u, chunk=16)
    h = torch.zeros(2, TG.rnn_width)
    outs = []
    for t in range(64):
        o, h = TR.rglru_step(p, u[:, t:t + 1], h)
        outs.append(o[:, 0])
    np.testing.assert_allclose(h_chunked.numpy(), torch.stack(outs, 1).numpy(),
                               atol=1e-4, rtol=1e-4)


def _port_block_vs_steps(apply, cfg, params, x, cache, **kw):
    full, _ = apply(cfg, params, x, **kw)
    outs = []
    for t in range(x.shape[1]):
        o, cache = apply(cfg, params, x[:, t:t + 1], cache)
        outs.append(o[:, 0])
    return full.numpy(), torch.stack(outs, 1).numpy()


def test_port_rglru_block_decode_matches_full():
    p = _port_params(TR.rglru_specs(TG))
    x = torch.from_numpy(_x(21, (2, 32, TG.d_model)))
    cache = {"conv": torch.zeros(2, TG.conv_width - 1, TG.rnn_width),
             "h": torch.zeros(2, TG.rnn_width)}
    full, step = _port_block_vs_steps(TR.rglru_block_apply, TG, p, x, cache)
    np.testing.assert_allclose(full, step, atol=2e-3, rtol=2e-3)


def test_port_mlstm_chunked_vs_recurrent():
    args = [torch.from_numpy(a) for a in _mlstm_inputs(22)]
    chunked = TR._mlstm_chunk_scan(*args, chunk=16)
    B, S, nh, dh = args[0].shape
    state = (torch.zeros(B, nh, dh, dh), torch.zeros(B, nh, dh), torch.full((B, nh), -1e30))
    outs = []
    for t in range(S):
        h, state = TR.mlstm_step(*(a[:, t:t + 1] for a in args), state)
        outs.append(h[:, 0])
    np.testing.assert_allclose(chunked.numpy(), torch.stack(outs, 1).numpy(),
                               atol=2e-3, rtol=2e-2)


def test_port_mlstm_block_decode_matches_full():
    p = _port_params(TR.mlstm_specs(TX))
    x = torch.from_numpy(_x(23, (1, 16, TX.d_model)))
    full, step = _port_block_vs_steps(TR.mlstm_block_apply, TX, p, x,
                                      _mlstm_cache(1, TX, torch), chunk=8)
    np.testing.assert_allclose(full, step, atol=5e-3, rtol=5e-2)


def test_port_slstm_block_decode_matches_full():
    p = _port_params(TR.slstm_specs(TX))
    d = TX.d_model
    x = torch.from_numpy(_x(24, (1, 16, d)))
    cache = {"state": tuple(torch.zeros(1, d) if i != 3 else torch.full((1, d), -1e30)
                            for i in range(4))}
    full, step = _port_block_vs_steps(TR.slstm_block_apply, TX, p, x, cache)
    np.testing.assert_allclose(full, step, atol=2e-3, rtol=2e-2)


# -- the model level ---------------------------------------------------------


def _shapes(tree, is_leaf):
    if isinstance(tree, dict):
        return {k: _shapes(v, is_leaf) for k, v in tree.items()}
    assert is_leaf(tree)
    dt = tree.dtype
    name = str(dt).removeprefix("torch.") if isinstance(dt, torch.dtype) else np.dtype(dt).name
    return tuple(tree.shape), name, tree.init


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", RECURRENT)
def test_spec_trees_match(arch, smoke):
    """Parameters and the contiguous cache (a local layer's ring of
    min(max_len, window) slots, the recurrent states, mLSTM's m at 0),
    shape, dtype and init, key for key."""
    j = jcfg.get_config(arch, smoke=smoke)
    t = tcfg.get_config(arch, smoke=smoke)
    assert _shapes(tlm.lm_specs(t), lambda x: True) == _shapes(jlm.lm_specs(j), j_is_param)
    for max_len in (20, 4096):
        assert _shapes(tlm.lm_cache_specs(t, 3, max_len), lambda x: True) == \
            _shapes(jlm.lm_cache_specs(j, 3, max_len), j_is_param)


@pytest.fixture(scope="module", params=RECURRENT)
def model(request):
    jc, tc = _cfgs(request.param)
    jp = jinit(jax.random.PRNGKey(1), jstate.model_specs(jc))
    return jc, tc, jp, from_jax_params(jax.tree.map(np.asarray, jp), "cpu")


def _tokens(seed, B, S, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


def test_lm_apply_no_cache_matches(model):
    jc, tc, jp, tp = model
    tok = _tokens(30, 2, 32, jc.vocab_size)
    jl, _, _ = jlm.lm_apply(jc, jp, jnp.asarray(tok), remat=False)
    with torch.no_grad():
        tl, _, _ = tlm.lm_apply(tc, tp, torch.from_numpy(tok), remat=False)
    _close(tl, jl, SCAN_TOL)
    # the no-cache prefill step's last logits are the forward's last row
    last = tstep.make_prefill_step(tc)(tp, {"tokens": torch.from_numpy(tok)})
    _close(last, np.asarray(jl[:, -1]), SCAN_TOL)


def _cache(specs, lib):
    if lib is torch:
        return map_tree(lambda p: torch.zeros(p.shape, dtype=p.dtype), specs)
    return jax.tree.map(lambda p: jnp.zeros(p.shape, p.dtype), specs, is_leaf=j_is_param)


@pytest.mark.parametrize("per_slot", [False, True])
def test_greedy_decode_replay_streams_match(model, per_slot):
    """40 greedy decode steps from a 4-token prompt fed token by token,
    scalar or [B] lengths, through both packages' decode steps over the
    contiguous cache (recurrentgemma's 16-slot ring wraps twice): the
    streams identical, the logits within the scan tolerance at every
    step, and the final caches equal."""
    jc, tc, jp, tp = model
    B, steps, prompt = 2, 40, _tokens(31, 2, 4, jc.vocab_size)
    max_len = 48
    jcache = _cache(jlm.lm_cache_specs(jc, B, max_len), jnp)
    tcache = _cache(tlm.lm_cache_specs(tc, B, max_len), torch)
    jdec = jax.jit(jstep.make_decode_step(jc))
    tdec = tstep.make_decode_step(tc)
    jtok, ttok = jnp.asarray(prompt[:, :1]), torch.from_numpy(prompt[:, :1])
    jstream, tstream = [], []
    for i in range(steps):
        jlen = jnp.full((B,), i, jnp.int32) if per_slot else jnp.asarray(i, jnp.int32)
        tlen = torch.full((B,), i, dtype=torch.int32) if per_slot else i
        jn, jl, jcache = jdec(jp, jtok, jcache, jlen)
        with torch.no_grad():
            tn, tl, tcache = tdec(tp, ttok, tcache, tlen)
        _close(tl, jl, SCAN_TOL)
        if i + 1 < prompt.shape[1]:
            jtok, ttok = jnp.asarray(prompt[:, i + 1:i + 2]), torch.from_numpy(prompt[:, i + 1:i + 2])
        else:
            jstream.append(np.asarray(jn))
            tstream.append(tn.numpy())
            jtok, ttok = jn[:, None], tn[:, None]
    np.testing.assert_array_equal(np.stack(tstream), np.stack(jstream))
    flat = jax.tree_util.tree_flatten_with_path(jcache)[0]
    assert len(flat) == len(tree_leaves(tcache))
    for path, leaf in flat:
        t = tcache
        for k in path:
            t = t[k.key]
        _close(t, leaf, SCAN_TOL)
    if jc.window:  # the ring wrapped
        assert steps > 2 * jc.window


def test_three_train_steps_match(model):
    """Three AdamW steps under remat: loss and grad-norm within 1e-4
    relative at every step."""
    jc, tc, _, _ = model
    js = jstate.init_train_state(jax.random.PRNGKey(0), jc, jcfg.RunConfig())
    ts = from_jax_params(jax.tree.map(np.asarray, js), "cpu")
    jfn = jax.jit(jstep.make_train_step(jc, jcfg.RunConfig()))
    tfn = tstep.make_train_step(tc, tcfg.RunConfig())
    for i in range(3):
        tok = _tokens(40 + i, 2, 32, jc.vocab_size)
        lab = np.roll(tok, -1, axis=1)
        js, jm = jfn(js, {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)})
        ts, tm = tfn(ts, {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab)})
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-4)


def test_launch_train_default_arch_trains_on_the_cpu(tmp_path):
    """The training driver's default architecture, the JAX package's
    xlstm-125m, runs its stage graph (smoke width) and its loss falls."""
    args = tlaunch.build_parser().parse_args(
        ["--device", "cpu", "--smoke", "--steps", "10", "--batch", "2", "--seq", "32",
         "--lr", "3e-3", "--ckpt-dir", str(tmp_path / "ckpt")])
    assert args.arch == "xlstm-125m"
    res = tlaunch.run(args)
    assert res["steps"] == 10 and res["improved"]


# -- refusals ----------------------------------------------------------------


def test_reference_fault_cached_prefill_is_refused(model):
    """JAX's lm_apply takes a cache with S > 1 over recurrent blocks: its
    cached step reads only the first token, so recurrentgemma's logits
    differ from its own token-by-token replay and xlstm's raise a
    TypeError at the reshape.  The port refuses the call before writing
    any cache."""
    jc, tc, jp, tp = model
    B, S = 2, 8
    tok = _tokens(50, B, S, jc.vocab_size)
    jcache = _cache(jlm.lm_cache_specs(jc, B, 16), jnp)
    if jc.attention == "xlstm":
        with pytest.raises(TypeError):
            jlm.lm_apply(jc, jp, jnp.asarray(tok), None, jcache, 0, remat=False)
    else:
        jbad, _, _ = jlm.lm_apply(jc, jp, jnp.asarray(tok), None, jcache, 0, remat=False)
        jcache = _cache(jlm.lm_cache_specs(jc, B, 16), jnp)
        dec = jax.jit(jstep.make_decode_step(jc))
        replay = []
        for i in range(S):
            _, lg, jcache = dec(jp, jnp.asarray(tok[:, i:i + 1]), jcache, jnp.asarray(i))
            replay.append(np.asarray(lg[:, 0]))
        gap = np.abs(np.asarray(jbad) - np.stack(replay, 1)).max()
        assert gap > 0.1, gap
        # the no-cache forward agrees with the replay
        jfull, _, _ = jlm.lm_apply(jc, jp, jnp.asarray(tok), remat=False)
        np.testing.assert_allclose(np.asarray(jfull), np.stack(replay, 1), **SCAN_TOL)
    tcache = _cache(tlm.lm_cache_specs(tc, B, 16), torch)
    with pytest.raises(NotImplementedError, match="one token at a time"):
        tlm.lm_apply(tc, tp, torch.from_numpy(tok), None, tcache, 0, remat=False)
    assert all(not t.any() for t in tree_leaves(tcache))


def _message(call):
    with pytest.raises(NotImplementedError) as info:
        call()
    return str(info.value)


@pytest.mark.parametrize("arch", RECURRENT)
def test_serving_refusals_are_jaxs(arch):
    """The engine (both layouts), the paged cache specs, the chunked and
    the cache-writing prefill refuse both archs with JAX's words, naming
    no queue item (they are the reference's limits, not the port's)."""
    j, t = jcfg.get_config(arch, smoke=True), tcfg.get_config(arch, smoke=True)
    pairs = {
        "paged_specs": (lambda: jlm.lm_paged_cache_specs(j, 4, 16),
                        lambda: tlm.lm_paged_cache_specs(t, 4, 16)),
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


# -- recurrentgemma under its published remat policy --------------------------


def _gemma_loss_and_grads(tc, tp, tok, remat):
    """The port's loss and grads of ``tp`` (the train step's loss)."""
    run = tcfg.RunConfig(remat="full" if remat else "none")
    leaves = [t.detach().requires_grad_() for t in tree_leaves(tp)]
    it = iter(leaves)
    loss = tstep.make_loss_fn(tc, run)(map_tree(lambda _: next(it), tp), {
        "tokens": torch.from_numpy(tok), "labels": torch.from_numpy(np.roll(tok, -1, 1))})
    return loss.item(), [g.numpy() for g in torch.autograd.grad(loss, leaves)]


@pytest.fixture(scope="module")
def gemma_save():
    """recurrentgemma's smoke config (fp32, two repetitions of its unit)
    under save_block_outputs, on JAX-initialised weights, and its batch."""
    jc, tc = JG.with_overrides(num_layers=6), TG.with_overrides(num_layers=6)
    jc, tc = [c.with_overrides(remat_policy="save_block_outputs") for c in (jc, tc)]
    jp = jinit(jax.random.PRNGKey(2), jstate.model_specs(jc))
    return jc, tc, jp, from_jax_params(jax.tree.map(np.asarray, jp), "cpu"), \
        _tokens(50, 2, 32, jc.vocab_size)


def test_recurrentgemma_save_block_outputs_matches_jax(gemma_save):
    """The published config's policy; its smoke config under it: loss and
    every grad within 1e-4 of JAX's under ``save_only_these_names(
    "block_out")``."""
    assert tcfg.get_config("recurrentgemma-9b").remat_policy == "save_block_outputs"
    jc, tc, jp, tp, tok = gemma_save
    batch = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(np.roll(tok, -1, 1))}
    jl, jg = jax.value_and_grad(jstep.make_loss_fn(jc, jcfg.RunConfig()))(jp, batch)
    tl, tg = _gemma_loss_and_grads(tc, tp, tok, remat=True)
    np.testing.assert_allclose(tl, float(jl), rtol=1e-4)
    jleaves = [leaf for _, leaf in jax.tree_util.tree_flatten_with_path(jg)[0]]
    # the port's dict order is JAX's sorted order at every level of this tree
    assert len(jleaves) == len(tg)
    for g, w in zip(tg, jleaves):
        _close(g, w, SCAN_TOL)


def test_remat_modes_agree(gemma_save):
    """No remat, "full" and "save_block_outputs" compute one function:
    the same loss and grads, bitwise on the CPU."""
    _, tc, _, tp, tok = gemma_save
    base = _gemma_loss_and_grads(tc, tp, tok, remat=False)
    for policy in ("full", "save_block_outputs"):
        loss, grads = _gemma_loss_and_grads(tc.with_overrides(remat_policy=policy), tp, tok,
                                            remat=True)
        assert loss == base[0], policy
        for g, w in zip(grads, base[1]):
            np.testing.assert_array_equal(g, w, err_msg=policy)


def test_save_block_outputs_recomputes_no_named_projection(gemma_save):
    """The policy saves what JAX's saves: the forward runs each block's
    output projection (named block_out: 2 x 3 a repetition, 12 in all)
    once; the backward of "full" recomputes every one the backward reads
    past (all but the last of each repetition: the recompute stops once
    it has what the backward needs), that of save_block_outputs none.
    The name is set only inside a save_block_outputs unit: under "full"
    it is counted with naming forced on, and without that nothing is
    named."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.models import blocks as TB

    class Named(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += func in tlm._MATMULS and TB.naming_block_out()
            return func(*args, **(kwargs or {}))

    _, tc, _, tp, tok = gemma_save
    reps = 2
    counts = {}
    for policy, forced in (("full", False), ("save_block_outputs", False), ("full", True)):
        cfg = tc.with_overrides(remat_policy=policy)
        leaves = [t.detach().requires_grad_() for t in tree_leaves(tp)]
        it = iter(leaves)
        fwd, bwd = Named(), Named()
        TB._NAMING.selecting = forced  # the CPU backward runs on this thread
        try:
            with fwd:
                logits, _, _ = tlm.lm_apply(cfg, map_tree(lambda _: next(it), tp),
                                            torch.from_numpy(tok))
            with bwd:
                torch.autograd.grad(logits.float().square().mean(), leaves)
        finally:
            TB._NAMING.selecting = False
        counts[policy, forced] = (fwd.n, bwd.n)
    assert counts == {("full", False): (0, 0), ("save_block_outputs", False): (6 * reps, 0),
                      ("full", True): (6 * reps, 5 * reps)}
