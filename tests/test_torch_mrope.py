"""Port parity for M-RoPE with embedding inputs (qwen2-vl-72b), on the CPU:
``apply_mrope`` and the RoPE choice of ``attn_apply`` against
``repro.models.blocks``, and ``lm_apply`` on embeddings (no cache and an
empty-cache prefill), the M-RoPE decode step, the loss and its grads and
three AdamW steps against ``repro`` at qwen2-vl's smoke config in fp32
compute, on shared weights (JAX-initialised, carried across by
``from_jax_params``) and numpy-seeded inputs.

The positions lay out an image block as a grid (t fixed, h and w its
rows and columns), then text (t = h = w): with equal t, h and w M-RoPE
is RoPE, and a test would show nothing.  Sequences stay within one whole
KV chunk (``kv_chunk`` 1024), where JAX's ``chunked_attention`` is exact.

Tolerances (fp32): 2e-5 for functions and blocks, 1e-4 for whole
forwards and losses."""
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
from repro.models import blocks as JB  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.train import state as jstate  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch.common.params import from_jax_params, map_tree, tree_leaves  # noqa: E402
from repro_torch.models import blocks as TB  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.train import state as tstate  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

TOL = dict(atol=2e-5, rtol=2e-5)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = "qwen2-vl-72b"
JC = dataclasses.replace(jcfg.get_config(ARCH, smoke=True), compute_dtype=jnp.float32)
TC = tcfg.get_config(ARCH, smoke=True).with_overrides(compute_dtype=torch.float32)
B = 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    jp = jinit(jax.random.PRNGKey(2), jstate.model_specs(JC))
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), "cpu")


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **tol)


def mrope_positions(Bsz, text_before, grid_h, grid_w, text_after):
    """[Bsz, S, 3] int32 (t, h, w): ``text_before`` text tokens, an image
    of ``grid_h`` x ``grid_w`` patches at one t (h and w its row and
    column, offset by the image's start), then ``text_after`` text
    tokens; a text token's t, h and w are its index in the sequence."""
    rows = [[i, i, i] for i in range(text_before)]
    s0 = text_before
    rows += [[s0, s0 + r, s0 + c] for r in range(grid_h) for c in range(grid_w)]
    n = len(rows)
    rows += [[i, i, i] for i in range(n, n + text_after)]
    return np.broadcast_to(np.asarray(rows, np.int32)[None], (Bsz, len(rows), 3)).copy()


# -- functions -----------------------------------------------------------------


@pytest.mark.parametrize("cfg", [TC, tcfg.get_config(ARCH)], ids=["smoke", "full"])
def test_apply_mrope_matches_with_distinct_t_h_w(cfg):
    pos = mrope_positions(B, 3, 4, 5, 6)
    assert (pos[..., 0] != pos[..., 1]).any() and (pos[..., 1] != pos[..., 2]).any()
    x = _x(0, (B, pos.shape[1], 3, cfg.head_dim))
    want = JB.apply_mrope(jnp.asarray(x), jnp.asarray(pos), cfg.rope_theta, cfg.mrope_sections)
    got = TB.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), cfg.rope_theta,
                         cfg.mrope_sections)
    _close(got, want, TOL)
    # and it is not RoPE at these positions
    rope = TB.apply_rope(torch.from_numpy(x), torch.from_numpy(pos[..., 0]), cfg.rope_theta)
    assert (got - rope).abs().max().item() > 1e-2


def test_apply_mrope_with_equal_t_h_w_is_rope():
    pos = np.broadcast_to(np.arange(9, dtype=np.int32)[None, :, None] * 3, (B, 9, 3)).copy()
    x = _x(1, (B, 9, 2, TC.head_dim))
    got = TB.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), TC.rope_theta,
                         TC.mrope_sections)
    rope = TB.apply_rope(torch.from_numpy(x), torch.from_numpy(pos[..., 0]), TC.rope_theta)
    torch.testing.assert_close(got, rope, rtol=0, atol=0)
    want = JB.apply_mrope(jnp.asarray(x), jnp.asarray(pos), TC.rope_theta, TC.mrope_sections)
    _close(got, want, TOL)


def test_plain_rope_config_reads_t_of_3d_positions():
    """``_rope_or_mrope`` under a config without ``mrope_sections`` turns
    by the t column of [B, S, 3] positions, as JAX's does."""
    jc = dataclasses.replace(JC, mrope_sections=())
    tc = TC.with_overrides(mrope_sections=())
    pos = mrope_positions(B, 2, 3, 3, 2)
    x = _x(2, (B, pos.shape[1], 2, TC.head_dim))
    got = TB._rope_or_mrope(tc, torch.from_numpy(x), torch.from_numpy(pos))
    _close(got, JB._rope_or_mrope(jc, jnp.asarray(x), jnp.asarray(pos)), TOL)
    torch.testing.assert_close(
        got, TB.apply_rope(torch.from_numpy(x), torch.from_numpy(pos[..., 0]), TC.rope_theta),
        rtol=0, atol=0)
    with pytest.raises(ValueError, match=r"\[B, S, 3\]"):
        TB.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos[..., 0]), TC.rope_theta,
                       TC.mrope_sections)


def test_attn_apply_with_mrope_matches(params):
    jp, tp = params
    jblk = jax.tree.map(lambda a: a[0], jp["unit"]["b0"]["t"])
    tblk = map_tree(lambda t: t[0], tp["unit"]["b0"]["t"])
    pos = mrope_positions(B, 2, 3, 4, 3)
    x = _x(3, (B, pos.shape[1], JC.d_model))
    want, _ = JB.attn_apply(JC, jblk, jnp.asarray(x), jnp.asarray(pos))
    got, _ = TB.attn_apply(TC, tblk, torch.from_numpy(x), torch.from_numpy(pos))
    _close(got, want, TOL)


# -- the model -------------------------------------------------------------------


def _inputs(seed, text_before=3, grid=(4, 4), text_after=5):
    pos = mrope_positions(B, text_before, *grid, text_after)
    return _x(seed, (B, pos.shape[1], JC.d_model)), pos


def test_lm_apply_on_embeddings_matches(params):
    jp, tp = params
    emb, pos = _inputs(4)
    want, _, _ = jlm.lm_apply(JC, jp, jnp.asarray(emb), jnp.asarray(pos), remat=False)
    with torch.no_grad():
        got, _, _ = tlm.lm_apply(TC, tp, torch.from_numpy(emb), torch.from_numpy(pos),
                                 remat=False)
    assert got.shape == (B, pos.shape[1], JC.padded_vocab)
    _close(got, want, MODEL_TOL)
    # the no-cache prefill step reads the batch's embeds and positions
    last = tstep.make_prefill_step(TC)(tp, {"embeds": torch.from_numpy(emb),
                                            "positions": torch.from_numpy(pos)})
    _close(last, np.asarray(want[:, -1]), MODEL_TOL)


def _zero_cache(specs, lib):
    if lib is torch:
        return map_tree(lambda p: torch.zeros(p.shape, dtype=p.dtype), specs)
    return jax.tree.map(lambda p: jnp.zeros(p.shape, p.dtype), specs, is_leaf=j_is_param)


def _cache_leaves_close(tcache, jcache):
    flat = jax.tree_util.tree_flatten_with_path(jcache)[0]
    assert len(flat) == len(tree_leaves(tcache))
    for path, leaf in flat:
        t = tcache
        for k in path:
            t = t[k.key]
        _close(t, leaf, MODEL_TOL)


def test_empty_cache_prefill_then_decode_matches(params):
    """The empty-cache prefill of S - 1 embedded positions and one M-RoPE
    decode step of the matching token at (p, p, p), p = S - 1, in both
    packages: logits and caches; and the port's pair equals its no-cache
    forward over all S positions, last logits."""
    jp, tp = params
    emb, pos = _inputs(5)
    S, max_len = pos.shape[1], pos.shape[1] + 4
    tok = np.random.default_rng(6).integers(0, JC.vocab_size, (B, 1)).astype(np.int32)
    emb[:, -1] = np.asarray(jp["embed"])[tok[:, 0]]  # the last input is that token
    jcache = _zero_cache(jlm.lm_cache_specs(JC, B, max_len), jnp)
    tcache = _zero_cache(tlm.lm_cache_specs(TC, B, max_len), torch)
    jl, jcache, _ = jlm.lm_apply(JC, jp, jnp.asarray(emb[:, :-1]), jnp.asarray(pos[:, :-1]),
                                 jcache, 0, remat=False)
    with torch.no_grad():
        tl, tcache, _ = tlm.lm_apply(TC, tp, torch.from_numpy(emb[:, :-1]),
                                     torch.from_numpy(pos[:, :-1]), tcache, 0)
    _close(tl, jl, MODEL_TOL)
    _cache_leaves_close(tcache, jcache)
    p = S - 1
    assert (pos[:, -1] == p).all()
    jn, jd, jcache = jax.jit(jstep.make_decode_step(JC))(jp, jnp.asarray(tok), jcache,
                                                         jnp.asarray(p, jnp.int32))
    with torch.no_grad():
        tn, td, tcache = tstep.make_decode_step(TC)(tp, torch.from_numpy(tok), tcache, p)
    _close(td, jd, MODEL_TOL)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    _cache_leaves_close(tcache, jcache)
    with torch.no_grad():
        full, _, _ = tlm.lm_apply(TC, tp, torch.from_numpy(emb), torch.from_numpy(pos),
                                  remat=False)
    _close(td[:, 0], full[:, -1], MODEL_TOL)


def test_decode_step_positions_are_cache_len_three_times(params, monkeypatch):
    """``make_decode_step`` hands lm_apply [B, 1, 3] positions, each
    (cache_len, cache_len, cache_len), as JAX's builds them."""
    _, tp = params
    seen = {}
    real = tlm.lm_apply

    def spy(cfg, params, inputs, positions=None, *a, **kw):
        seen["positions"] = positions
        return real(cfg, params, inputs, positions, *a, **kw)

    monkeypatch.setattr(tstep, "lm_apply", spy)
    cache = _zero_cache(tlm.lm_cache_specs(TC, B, 16), torch)
    with torch.no_grad():
        tstep.make_decode_step(TC)(tp, torch.ones((B, 1), dtype=torch.int32), cache,
                                   torch.tensor(9))
    assert seen["positions"].shape == (B, 1, 3)
    assert (seen["positions"] == 9).all()


def _batch(seed, lib):
    emb, pos = _inputs(seed)
    lab = np.random.default_rng(seed + 1).integers(0, JC.vocab_size, pos.shape[:2]).astype(
        np.int32)
    conv = jnp.asarray if lib is jnp else torch.from_numpy
    return {"embeds": conv(emb), "positions": conv(pos), "labels": conv(lab)}


def test_loss_and_grads_match(params):
    """One loss and its gradient, leaf by leaf, under remat (the token
    embedding, unread on embedding inputs, gets zeros from both)."""
    jp, tp = params
    jl, jg = jax.value_and_grad(jstep.make_loss_fn(JC, jcfg.RunConfig()))(jp, _batch(7, jnp))
    leaves = [t.detach().requires_grad_() for t in tree_leaves(tp)]
    it = iter(leaves)
    loss = tstep.make_loss_fn(TC, tcfg.RunConfig())(map_tree(lambda _: next(it), tp),
                                                     _batch(7, torch))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-4)
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(grads)
    for t, j in zip(grads, jleaves):
        _close(t, j, MODEL_TOL)


def test_three_train_steps_match():
    """Three AdamW steps on embeddings and M-RoPE positions: loss and
    grad-norm within 1e-4 relative at every step."""
    run = jcfg.RunConfig()
    js = jstate.init_train_state(jax.random.PRNGKey(0), JC, run)
    ts = from_jax_params(jax.tree.map(np.asarray, js), "cpu")
    jfn = jax.jit(jstep.make_train_step(JC, run))
    tfn = tstep.make_train_step(TC, tcfg.RunConfig())
    for i in range(3):
        js, jm = jfn(js, _batch(10 + i, jnp))
        ts, tm = tfn(ts, _batch(10 + i, torch))
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-4)

