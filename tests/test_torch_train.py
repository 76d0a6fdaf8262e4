"""Port parity for the training slice, on the CPU: the optimizers, the
loss and clipping, the train-state specs, whole train steps, the
no-cache and empty-cache prefills and the synthetic corpus, against
``repro`` on the tinyllama smoke config in fp32, from the same
(JAX-initialised) state carried across key for key."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jcfg  # noqa: E402
import repro_torch.configs as tcfg  # noqa: E402
from repro.common.params import Param as JParam  # noqa: E402
from repro.common.params import init_params as jinit_params  # noqa: E402
from repro.common.params import is_param  # noqa: E402
from repro.launch.train import make_corpus as jcorpus  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import state as jstate  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch.common.params import (Param, from_jax_params, map_tree,  # noqa: E402
                                       to_numpy, tree_leaves)
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import state as tstate  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

JCFG = dataclasses.replace(jcfg.get_config("tinyllama-1.1b", smoke=True),
                           compute_dtype=jnp.float32)
TCFG = tcfg.get_config("tinyllama-1.1b", smoke=True).with_overrides(
    compute_dtype=torch.float32)
# fp32 logits, losses and norms: sums in another order (the repo's 2e-5)
TOL = dict(atol=2e-5, rtol=2e-5)
# parameters and optimizer states after AdamW steps: m / sqrt(v) turns a
# last-bit difference of a near-zero gradient into up to ~7e-6 of a step
STATE_TOL = dict(atol=3e-5, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_trees(got, want, **tol):
    """Port tree against JAX tree, key for key."""
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat) == len(tree_leaves(got))
    for path, leaf in flat:
        t = got
        for k in path:
            t = t[k.key]
        np.testing.assert_allclose(to_numpy(t), np.asarray(leaf, np.float32)
                                   if leaf.dtype == jnp.bfloat16 else np.asarray(leaf),
                                   err_msg=jax.tree_util.keystr(path), **tol)


def _batch(seed, B=4, S=32):
    tok = np.random.default_rng(seed).integers(0, JCFG.vocab_size, (B, S)).astype(np.int32)
    return tok, np.roll(tok, -1, axis=1)


# -- configs, specs ----------------------------------------------------------


def test_shapes_and_default_run_configs_match():
    assert {k: dataclasses.astuple(v) for k, v in tcfg.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in jcfg.SHAPES.items()}
    assert {k: dataclasses.astuple(v) for k, v in tcfg.SMOKE_SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in jcfg.SMOKE_SHAPES.items()}
    for arch in jcfg.ARCHS:
        for shape in jcfg.SHAPES:
            t = dataclasses.asdict(tcfg.default_run_config(arch, shape))
            j = dataclasses.asdict(jcfg.default_run_config(arch, shape))
            t["opt_state_dtype"] = str(t["opt_state_dtype"]).removeprefix("torch.")
            j["opt_state_dtype"] = np.dtype(j["opt_state_dtype"]).name
            assert t == j, (arch, shape)


def _spec_tree(tree):
    if isinstance(tree, dict):
        return {k: _spec_tree(v) for k, v in tree.items()}
    dt = tree.dtype
    name = str(dt).removeprefix("torch.") if isinstance(dt, torch.dtype) else np.dtype(dt).name
    return tuple(tree.shape), name, tree.init


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_train_state_specs_match(optimizer):
    jrun = jcfg.RunConfig(optimizer=optimizer)
    trun = tcfg.RunConfig(optimizer=optimizer)
    for j, t in ((JCFG, TCFG),
                 (dataclasses.replace(JCFG, param_dtype=jnp.bfloat16),
                  TCFG.with_overrides(param_dtype=torch.bfloat16))):
        assert _spec_tree(tstate.train_state_specs(t, trun)) == \
            _spec_tree(jstate.train_state_specs(j, jrun))


def test_init_train_state_defaults_to_the_card():
    import inspect

    assert inspect.signature(tstate.init_train_state).parameters["device"].default == "cuda"
    s = tstate.init_train_state(torch.Generator().manual_seed(0), TCFG,
                                tcfg.RunConfig(), device="cpu")
    assert s["step"].shape == () and s["step"].dtype == torch.int32
    assert s["params"]["embed"].dtype == torch.float32


# -- optimizers, loss, clipping ----------------------------------------------


def _random_tree(rng, grad_dtype=np.float32):
    """Params, grads and optimizer inputs on a tree with a factored
    matrix, a stacked factored leaf, a small matrix and a vector."""
    shapes = {"w": (16, 24), "stack": {"u": (3, 8, 12)}, "small": (4, 9), "b": (8,)}
    params = jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32), shapes,
                          is_leaf=lambda x: isinstance(x, tuple))
    grads = jax.tree.map(lambda p: (0.1 * rng.standard_normal(p.shape)).astype(grad_dtype),
                         params)
    specs = jax.tree.map(lambda p: JParam(p.shape, (None,) * p.ndim), params)
    tspecs = jax.tree.map(lambda p: Param(p.shape, (None,) * p.ndim), params)
    return params, grads, specs, tspecs


def _random_state(rng, jspecs):
    return jax.tree.map(lambda p: np.abs(rng.standard_normal(p.shape)).astype(np.float32) * 0.01,
                        jspecs, is_leaf=is_param)


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_optimizer_update_matches(optimizer):
    rng = np.random.default_rng(11)
    params, grads, jspecs, tspecs = _random_tree(rng)
    run_j = jcfg.RunConfig(optimizer=optimizer)
    run_t = tcfg.RunConfig(optimizer=optimizer)
    state = _random_state(rng, jopt.opt_specs(jspecs, run_j))
    step = np.int32(4)
    want_p, want_s = jax.jit(jopt.opt_update, static_argnums=4)(
        grads, state, params, jnp.asarray(step), run_j)
    tp, ts = from_jax_params(params, "cpu"), from_jax_params(state, "cpu")
    assert _spec_tree(topt.opt_specs(tspecs, run_t)) == \
        _spec_tree(jopt.opt_specs(jspecs, run_j))
    got_p, got_s = topt.opt_update(from_jax_params(grads, "cpu"), ts, tp,
                                   torch.tensor(step), run_t)
    assert got_p is tp and got_s is ts  # updated in place
    _assert_trees(got_p, want_p, **TOL)
    _assert_trees(got_s, want_s, **TOL)


def test_adafactor_bf16_gradients_match():
    """bf16 gradients on fp32 parameters: the scale and the clip factor are
    cast to the gradient's dtype and the update promotes as in JAX."""
    rng = np.random.default_rng(12)
    params, grads, jspecs, _ = _random_tree(rng)
    grads = jax.tree.map(lambda g: jnp.asarray(g, jnp.bfloat16), grads)
    run_j, run_t = (jcfg.RunConfig(optimizer="adafactor"),
                    tcfg.RunConfig(optimizer="adafactor"))
    state = _random_state(rng, jopt.opt_specs(jspecs, run_j))
    want_p, _ = jax.jit(jopt.opt_update, static_argnums=4)(
        grads, state, params, jnp.asarray(0), run_j)
    got_p, _ = topt.opt_update(from_jax_params(jax.tree.map(np.asarray, grads), "cpu"),
                               from_jax_params(state, "cpu"),
                               from_jax_params(params, "cpu"), torch.tensor(0), run_t)
    # the bf16 scale may round one ulp (2^-8 relative) apart when its fp32
    # source differs in the last bit; on an update of |u| <= ~20 that is
    # lr * 20 * 2^-8 ~ 2.3e-5 on the parameter
    _assert_trees(got_p, want_p, atol=5e-5, rtol=1e-5)


def test_clip_and_cross_entropy_match():
    rng = np.random.default_rng(13)
    tree = {"a": rng.standard_normal((5, 7)).astype(np.float32),
            "b": {"c": rng.standard_normal((11,)).astype(np.float32)}}
    for max_norm in (0.5, 100.0):
        want, wn = jstep.clip_by_global_norm(jax.tree.map(jnp.asarray, tree), max_norm)
        got, gn = tstep.clip_by_global_norm(from_jax_params(tree, "cpu"), max_norm)
        np.testing.assert_allclose(gn.item(), float(wn), **TOL)
        _assert_trees(got, want, **TOL)
    logits = (3 * rng.standard_normal((2, 6, 40))).astype(np.float32)
    labels = rng.integers(0, 40, (2, 6)).astype(np.int32)
    want, wgrad = jax.value_and_grad(jstep.cross_entropy)(jnp.asarray(logits),
                                                          jnp.asarray(labels))
    tl = torch.from_numpy(logits).requires_grad_()
    got = tstep.cross_entropy(tl, torch.from_numpy(labels))
    (tgrad,) = torch.autograd.grad(got, tl)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(wgrad), **TOL)


# -- train steps -------------------------------------------------------------


@pytest.mark.parametrize("optimizer,micro,remat", [
    ("adamw", 1, "layer"), ("adamw", 2, "layer"), ("adamw", 1, "none"),
    ("adafactor", 1, "layer")])
def test_train_steps_match(optimizer, micro, remat):
    """Loss and grad-norm at each of 3 steps, and the whole state (params,
    optimizer state, step) after steps 1 and 3."""
    run_j = jcfg.RunConfig(optimizer=optimizer, num_microbatches=micro, remat=remat)
    run_t = tcfg.RunConfig(optimizer=optimizer, num_microbatches=micro, remat=remat)
    js = jstate.init_train_state(jax.random.PRNGKey(0), JCFG, run_j)
    ts = from_jax_params(jax.tree.map(np.asarray, js), "cpu")
    jfn = jax.jit(jstep.make_train_step(JCFG, run_j))
    tfn = tstep.make_train_step(TCFG, run_t)
    for i in range(3):
        tok, lab = _batch(i)
        js, jm = jfn(js, {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)})
        ts, tm = tfn(ts, {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab)})
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), **TOL)
        np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]), **TOL)
        if i in (0, 2):
            _assert_trees(ts, js, **STATE_TOL)
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == 3


@pytest.mark.parametrize("arch", ["minicpm3-4b", "moonshot-v1-16b-a3b"])
def test_mla_and_moe_train_steps_match(arch):
    """Three AdamW steps of the MLA and the MoE smoke configs (the loss
    adds 0.01 x the summed MoE aux loss): loss and grad-norm within 1e-4
    relative at every step, and the whole state after the third."""
    jc = dataclasses.replace(jcfg.get_config(arch, smoke=True), compute_dtype=jnp.float32)
    tc = tcfg.get_config(arch, smoke=True).with_overrides(compute_dtype=torch.float32)
    js = jstate.init_train_state(jax.random.PRNGKey(0), jc, jcfg.RunConfig())
    ts = from_jax_params(jax.tree.map(np.asarray, js), "cpu")
    jfn = jax.jit(jstep.make_train_step(jc, jcfg.RunConfig()))
    tfn = tstep.make_train_step(tc, tcfg.RunConfig())
    for i in range(3):
        tok, lab = _batch(i)
        js, jm = jfn(js, {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)})
        ts, tm = tfn(ts, {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab)})
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-4)
    # the state: an element whose gradient sits at the fp32 noise floor
    # (moonshot's embedding row of a rarely routed token) has m / sqrt(v)
    # set by its last bits, a step of any size up to the lr (3e-4); seen
    # 3.3e-5 after three steps, so a third of one step
    _assert_trees(ts, js, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("remat_policy", ["full", "save_block_outputs"])
def test_int8_grad_compression_and_remat_policy_steps_match(remat_policy):
    """``grad_compression="int8"`` is read by neither package's step: both
    compute the uncompressed step (a data-parallel loop syncs with
    ``distributed.collectives.compressed_grad_sync``).  Three AdamW steps
    under each remat policy: loss and grad-norm at each step, and the whole
    state after the third, against JAX's on the same weights."""
    jc = dataclasses.replace(JCFG, remat_policy=remat_policy)
    tc = TCFG.with_overrides(remat_policy=remat_policy)
    run_j = jcfg.RunConfig(grad_compression="int8")
    run_t = tcfg.RunConfig(grad_compression="int8")
    js = jstate.init_train_state(jax.random.PRNGKey(0), jc, run_j)
    ts = from_jax_params(jax.tree.map(np.asarray, js), "cpu")
    jfn = jax.jit(jstep.make_train_step(jc, run_j))
    tfn = tstep.make_train_step(tc, run_t)
    plain = tstep.make_train_step(tc, tcfg.RunConfig())
    tp = from_jax_params(jax.tree.map(np.asarray, js), "cpu")
    for i in range(3):
        tok, lab = _batch(i)
        js, jm = jfn(js, {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)})
        batch = {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab)}
        ts, tm = tfn(ts, batch)
        tp, pm = plain(tp, batch)
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), **TOL)
        np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]), **TOL)
        assert tm["loss"].item() == pm["loss"].item()  # the field changes nothing
    _assert_trees(ts, js, **STATE_TOL)


# -- prefills ----------------------------------------------------------------


@pytest.fixture(scope="module")
def params():
    jp = jinit_params(jax.random.PRNGKey(1), jstate.model_specs(JCFG))
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), "cpu")


def test_prefill_step_last_logits_match(params):
    jp, tp = params
    tok, _ = _batch(5, B=3, S=24)
    want = jstep.make_prefill_step(JCFG)(jp, {"tokens": jnp.asarray(tok)})
    got = tstep.make_prefill_step(TCFG)(tp, {"tokens": torch.from_numpy(tok)})
    assert got.shape == (3, TCFG.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # and the last row of the full no-cache forward, without remat
    full, _, _ = tlm.lm_apply(TCFG, tp, torch.from_numpy(tok), remat=False)
    np.testing.assert_allclose(full[:, -1].numpy(), got.numpy(), **TOL)


def test_empty_cache_prefill_matches(params):
    """The S>1 prefill without chunk_lens: the prompt's K/V land at offset
    0 of a zero cache and the logits are the no-cache forward's.  JAX's
    default positions here are [B, 1] copies of the base (every token at
    position 0; ROADMAP.md queue 3), so both get explicit positions, and
    the port's default is pinned to ``arange(S)``."""
    jp, tp = params
    B, S, max_len = 2, 12, 16
    tok, _ = _batch(6, B=B, S=S)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    jcache = jax.tree.map(lambda p: jnp.zeros(p.shape, p.dtype),
                          jlm.lm_cache_specs(JCFG, B, max_len), is_leaf=is_param)
    tcache = map_tree(lambda p: torch.zeros(p.shape, dtype=p.dtype),
                      tlm.lm_cache_specs(TCFG, B, max_len))
    jl, jc, _ = jlm.lm_apply(JCFG, jp, jnp.asarray(tok), jnp.asarray(pos), jcache, 0,
                             remat=False)
    tl, tc, _ = tlm.lm_apply(TCFG, tp, torch.from_numpy(tok), torch.from_numpy(pos),
                             tcache, 0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_trees(tc, jc, **TOL)
    assert not tc["unit"]["b0"]["k"][:, S:].any()
    default, _, _ = tlm.lm_apply(
        TCFG, tp, torch.from_numpy(tok), None,
        map_tree(lambda p: torch.zeros(p.shape, dtype=p.dtype),
                 tlm.lm_cache_specs(TCFG, B, max_len)), 0)
    np.testing.assert_allclose(default.numpy(), tl.numpy(), rtol=0, atol=0)
    jdefault, _, _ = jlm.lm_apply(JCFG, jp, jnp.asarray(tok), None, jcache, 0, remat=False)
    jzero, _, _ = jlm.lm_apply(JCFG, jp, jnp.asarray(tok), jnp.zeros((B, S), jnp.int32),
                               jcache, 0, remat=False)
    np.testing.assert_allclose(np.asarray(jdefault), np.asarray(jzero), **TOL)
    with pytest.raises(NotImplementedError, match="EMPTY"):
        tlm.lm_apply(TCFG, tp, torch.from_numpy(tok), None, tc, 3)
    with pytest.raises(ValueError, match="scalar"):
        tlm.lm_apply(TCFG, tp, torch.from_numpy(tok), None, tc, torch.zeros(B))


def test_make_corpus_is_identical():
    for vocab, n, seed in ((32000, 4099, 0), (256, 1000, 3)):
        np.testing.assert_array_equal(tlaunch.make_corpus(vocab, n, seed),
                                      jcorpus(vocab, n, seed))
