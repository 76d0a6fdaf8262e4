"""Port parity for multi-head latent attention (minicpm3's MLA) against
``repro`` on the minicpm3 smoke config in fp32, with the same
(JAX-initialised) weights and the same numpy inputs: every branch of
``mla_apply`` on both cache layouts, ``lm_apply``'s logits, and the
ServeEngine's greedy streams against the JAX engine's, token for token."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from benchmarks.workload import mixed_workload  # noqa: E402
from repro.common.params import init_params  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.models import blocks as jb  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.train.state import model_specs  # noqa: E402
from repro_torch.common.params import from_jax_params, map_tree  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.kernels import prefill_attention as tpa  # noqa: E402
from repro_torch.models import blocks as tb  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.serve import RequestState, ServeEngine  # noqa: E402

ARCH = "minicpm3-4b"
JCFG = dataclasses.replace(jget(ARCH, smoke=True), compute_dtype=jnp.float32)
CFG32 = tget(ARCH, smoke=True).with_overrides(compute_dtype=torch.float32)
# fp32 sums in another order (the repo's 2e-5)
TOL = dict(atol=2e-5, rtol=2e-5)
B, S, PAGE = 4, 32, 8
NUM_PAGES = B * S // PAGE


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # the CPU is shared with the other test workers: torch's intra-op pool
    # only contends for it at these sizes
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    jp = init_params(jax.random.PRNGKey(0), model_specs(JCFG))
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def block(params):
    """The first layer's MLA parameters, JAX and port."""
    jp, tp = params
    return (jax.tree.map(lambda a: a[0], jp["unit"]["b0"]["t"]),
            map_tree(lambda t: t[0], tp["unit"]["b0"]["t"]))


def _np(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _tables(rng, need_pages):
    """[B, S // PAGE] block tables over a shuffled pool; logical pages at
    or past each row's ``need_pages`` entry are the sentinel."""
    mp = S // PAGE
    perm = rng.permutation(NUM_PAGES).astype(np.int32).reshape(B, mp)
    return np.where(np.arange(mp)[None, :] < np.asarray(need_pages)[:, None], perm,
                    NUM_PAGES).astype(np.int32)


def _both(x):
    return jnp.asarray(x), torch.from_numpy(np.array(x))


def _pools(rng):
    return (_np(rng, (NUM_PAGES, PAGE, JCFG.kv_lora_rank)),
            _np(rng, (NUM_PAGES, PAGE, JCFG.rope_head_dim)))


def _rows(rng):
    return _np(rng, (B, S, JCFG.kv_lora_rank)), _np(rng, (B, S, JCFG.rope_head_dim))


def _run_branch(branch, jp, tp, rng):
    """One branch of mla_apply on both packages -> [(name, port, jax)]."""
    T = 6
    pos = lambda base, n: (np.asarray(base, np.int32).reshape(-1, 1)  # noqa: E731
                           + np.arange(n, dtype=np.int32)[None, :]).astype(np.int32)
    if branch == "full":
        x = _np(rng, (B, 10, JCFG.d_model))
        p = np.broadcast_to(np.arange(10, dtype=np.int32), (B, 10)).copy()
        jcache, tcache, jkw, tkw = None, None, {}, {}
    elif branch == "batched_prefill":
        x = _np(rng, (B, T, JCFG.d_model))
        p = pos(np.zeros(B), T)
        ckv, kpe = _rows(rng)
        jcache = {"c_kv": jnp.asarray(ckv), "k_pe": jnp.asarray(kpe), "len": 0}
        tcache = {"c_kv": torch.from_numpy(ckv.copy()), "k_pe": torch.from_numpy(kpe.copy()),
                  "len": 0}
        jkw, tkw = {}, {}
    elif branch.startswith("ragged"):
        # rows: a full chunk at 0, an empty row, one token, a partial chunk
        base, clens = np.array([0, 5, 9, 20], np.int32), np.array([T, 0, 1, 4], np.int32)
        x = _np(rng, (B, T, JCFG.d_model))
        p = pos(base, T)
        (jb_, tb_), (jc, tc) = _both(base), _both(clens)
        jkw, tkw = {"chunk_lens": jc}, {"chunk_lens": tc}
        if branch == "ragged_paged":
            ckv, kpe = _pools(rng)
            bt = _tables(rng, -(-(base + clens) // PAGE))
            jcache = {"ckv_pages": jnp.asarray(ckv), "kpe_pages": jnp.asarray(kpe),
                      "block_table": jnp.asarray(bt), "len": jb_}
            tcache = {"ckv_pages": torch.from_numpy(ckv.copy()),
                      "kpe_pages": torch.from_numpy(kpe.copy()),
                      "block_table": torch.from_numpy(bt), "len": tb_}
        else:
            ckv, kpe = _rows(rng)
            jcache = {"c_kv": jnp.asarray(ckv), "k_pe": jnp.asarray(kpe), "len": jb_}
            tcache = {"c_kv": torch.from_numpy(ckv.copy()),
                      "k_pe": torch.from_numpy(kpe.copy()), "len": tb_}
    else:
        x = _np(rng, (B, 1, JCFG.d_model))
        jkw, tkw = {}, {}
        if branch == "scalar_decode":
            p = np.full((B, 1), 7, np.int32)
            jl, tl = 7, torch.tensor(7, dtype=torch.int32)
        else:
            # an empty row, one mid-page, a page edge, one on the last position
            lens = np.array([0, 3, 8, S - 1], np.int32)
            p = lens[:, None].copy()
            jl, tl = _both(lens)
        if branch == "paged_decode":
            ckv, kpe = _pools(rng)
            bt = _tables(rng, [1, 1, 2, 4])
            bt[1, 0] = NUM_PAGES  # row 1's page is unallocated: its append drops
            jcache = {"ckv_pages": jnp.asarray(ckv), "kpe_pages": jnp.asarray(kpe),
                      "block_table": jnp.asarray(bt), "len": jl}
            tcache = {"ckv_pages": torch.from_numpy(ckv.copy()),
                      "kpe_pages": torch.from_numpy(kpe.copy()),
                      "block_table": torch.from_numpy(bt), "len": tl}
        else:
            ckv, kpe = _rows(rng)
            jcache = {"c_kv": jnp.asarray(ckv), "k_pe": jnp.asarray(kpe), "len": jl}
            tcache = {"c_kv": torch.from_numpy(ckv.copy()),
                      "k_pe": torch.from_numpy(kpe.copy()), "len": tl}
    jy, jnc = jb.mla_apply(JCFG, jp, jnp.asarray(x), jnp.asarray(p), jcache, **jkw)
    ty, tnc = tb.mla_apply(CFG32, tp, torch.from_numpy(x), torch.from_numpy(p), tcache, **tkw)
    out = [("y", ty, jy)]
    if jnc is not None:
        for key in jnc:
            if key != "block_table":
                out.append((key, tnc[key], jnc[key]))
    return out


BRANCHES = ["full", "batched_prefill", "ragged_contiguous", "ragged_paged",
            "paged_decode", "slot_decode", "scalar_decode"]


@pytest.mark.parametrize("branch", BRANCHES)
def test_mla_apply_branch_matches(block, branch):
    """Every branch's output and written caches within 2e-5 (the latents
    are computed, so they carry the sums' last bits), the lengths
    exactly."""
    jp, tp = block
    for name, got, want in _run_branch(branch, jp, tp, np.random.default_rng(3)):
        got = torch.as_tensor(got).numpy()
        if name == "len":
            np.testing.assert_array_equal(got, np.asarray(want), err_msg=branch)
        else:
            np.testing.assert_allclose(got, np.asarray(want), err_msg=f"{branch} {name}",
                                       **TOL)


def test_latent_writes_drop_what_they_must():
    """The latent caches share the GQA caches' plain scatters, now written
    by index arithmetic alone (no boolean-mask index, which syncs the
    card's host; tests/test_torch_cuda.py runs the MLA path under
    sync-debug "error"): at widths of their own, writes to sentinel
    pages, past the row, before it and past ``chunk_lens`` all drop and
    leave the cache as it was."""
    ckv = torch.randn(NUM_PAGES, PAGE, 4)
    before = ckv.clone()
    bt = torch.full((B, S // PAGE), NUM_PAGES, dtype=torch.int32)
    tpa.write_chunk_paged(ckv, bt, torch.randn(B, 3, 4), torch.zeros(B), 3)
    tpa.paged_append_plain(ckv, bt, torch.tensor([0, 5, 9, 31]), torch.randn(B, 4))
    assert torch.equal(ckv, before)
    rows = torch.randn(B, S, 4)
    before = rows.clone()
    tpa.write_chunk(rows, torch.randn(B, 3, 4), torch.tensor([S, S + 2, -5, 0]),
                    torch.tensor([2, 3, 3, 0]))
    assert torch.equal(rows, before)


def test_mla_pad_heads_stay_exact():
    """minicpm3 pads H 40 to 48 (head_pad_multiple 16): the parameter and
    cache shapes are JAX's at full width, the latent caches in place of
    K/V.  At smoke width padded the same way (H 4 -> 8), pad heads with
    zero weights give exact zeros out of the expanded decode (their V is
    zero, and so is the V pad from v_head_dim to nope + rope), and the
    padded block computes the unpadded one."""
    jc, tc = jget(ARCH), tget(ARCH)
    assert tc.padded_gqa() == jc.padded_gqa() == (48, 48)
    specs = tlm.lm_specs(tc)["unit"]["b0"]["t"]
    assert specs["wk_b"].shape == (62, 256, 48, 64)
    assert specs["wo"].shape == (62, 48, 64, 2560)
    assert tlm.lm_cache_specs(tc, 8, 512)["unit"]["b0"]["c_kv"].shape == (62, 8, 512, 256)
    assert tlm.serving_attention_shapes(tc) == {"decode_attention": (48, 48, 96)}

    cfg = CFG32.with_overrides(head_pad_multiple=8)
    H, real = cfg.padded_gqa()[0], CFG32.num_heads
    assert H == 8
    gen = torch.Generator().manual_seed(0)
    from repro_torch.common.params import init_params as tinit
    p = tinit(gen, tb.mla_specs(cfg), "cpu")
    for key, axis in (("wq_b", 1), ("wk_b", 1), ("wv_b", 1), ("wo", 0)):
        p[key].narrow(axis, real, H - real).zero_()
    unpadded = {k: (v.narrow(1 if k != "wo" else 0, 0, real) if k in ("wq_b", "wk_b", "wv_b", "wo")
                    else v) for k, v in p.items()}
    rng = np.random.default_rng(7)
    q_nope = torch.from_numpy(_np(rng, (B, 1, H, cfg.nope_head_dim)))
    q_pe = torch.from_numpy(_np(rng, (B, 1, H, cfg.rope_head_dim)))
    ckv, kpe = (torch.from_numpy(a) for a in _rows(rng))
    lens = torch.tensor([0, 3, 17, S], dtype=torch.int32)
    o = tb._mla_expanded_decode(cfg, p, q_nope, q_pe, ckv, kpe, lens, torch.float32)
    assert o.shape == (B, 1, H, cfg.v_head_dim)
    assert torch.equal(o[:, :, real:], torch.zeros_like(o[:, :, real:]))
    x = torch.from_numpy(_np(rng, (B, 10, cfg.d_model)))
    pos = torch.arange(10, dtype=torch.int32).expand(B, 10)
    y_pad, _ = tb.mla_apply(cfg, p, x, pos)
    y, _ = tb.mla_apply(CFG32, unpadded, x, pos)
    np.testing.assert_allclose(y_pad.numpy(), y.numpy(), **TOL)


def test_lm_apply_logits_match(params):
    """No-cache logits, then a ragged chunk prefill and a per-slot decode
    through lm_apply on each layout."""
    jp, tp = params
    rng = np.random.default_rng(5)
    tok = rng.integers(0, JCFG.vocab_size, (B, 9)).astype(np.int32)
    jl, _, _ = jlm.lm_apply(JCFG, jp, jnp.asarray(tok), remat=False)
    tl, _, _ = tlm.lm_apply(CFG32, tp, torch.from_numpy(tok), remat=False)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), **TOL)
    clens = np.array([9, 4, 0, 1], np.int32)
    base = np.zeros(B, np.int32)
    bt = _tables(rng, [2, 1, 1, 1])
    for paged in (False, True):
        if paged:
            jcache = jax.tree.map(lambda p: jnp.zeros(p.shape, p.dtype),
                                  jlm.lm_paged_cache_specs(JCFG, NUM_PAGES, PAGE),
                                  is_leaf=lambda p: hasattr(p, "init"))
            tcache = map_tree(lambda p: torch.zeros(p.shape, dtype=p.dtype),
                              tlm.lm_paged_cache_specs(CFG32, NUM_PAGES, PAGE))
            jkw, tkw = {"block_table": jnp.asarray(bt)}, {"block_table": torch.from_numpy(bt)}
        else:
            jcache = jax.tree.map(lambda p: jnp.zeros(p.shape, p.dtype),
                                  jlm.lm_cache_specs(JCFG, B, S),
                                  is_leaf=lambda p: hasattr(p, "init"))
            tcache = map_tree(lambda p: torch.zeros(p.shape, dtype=p.dtype),
                              tlm.lm_cache_specs(CFG32, B, S))
            jkw, tkw = {}, {}
        jl, jcache, _ = jlm.lm_apply(JCFG, jp, jnp.asarray(tok), None, jcache,
                                     jnp.asarray(base), chunk_lens=jnp.asarray(clens), **jkw)
        tl, tcache, _ = tlm.lm_apply(CFG32, tp, torch.from_numpy(tok), None, tcache,
                                     torch.from_numpy(base), chunk_lens=torch.from_numpy(clens),
                                     **tkw)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        nxt = rng.integers(0, JCFG.vocab_size, (B, 1)).astype(np.int32)
        jl, _, _ = jlm.lm_apply(JCFG, jp, jnp.asarray(nxt), None, jcache,
                                jnp.asarray(clens), **jkw)
        tl, _, _ = tlm.lm_apply(CFG32, tp, torch.from_numpy(nxt), None, tcache,
                                torch.from_numpy(clens), **tkw)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), err_msg=f"paged={paged}", **TOL)


def _serve(eng, work):
    reqs = [eng.submit(p, max_new_tokens=int(g)) for p, g in work]
    eng.run_until_drained()
    return reqs


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
@pytest.mark.parametrize("chunk", [64, None])
@pytest.mark.parametrize("slots", [2, 4])
def test_streams_match_jax_engine(params, slots, chunk, layout):
    """Greedy streams of the mixed workload, token for token, and the same
    scheduling: the cache holds latents, the decode expands them."""
    jp, tp = params
    work = [(p, g) for _, p, g in mixed_workload(6, seed=1)]
    kw = dict(max_slots=slots, max_len=192, prefill_chunk_tokens=chunk, kv_layout=layout)
    want = _serve(JEngine(JCFG, params=jp, **kw), work)
    eng = ServeEngine(CFG32, params=tp, device="cpu", **kw)
    got = _serve(eng, work)
    assert all(r.state is RequestState.DONE for r in got)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    stats = eng.stats()
    assert stats["kv_bytes_per_token"] > 0
    if layout == "paged":
        assert eng.pages_in_use() == 0 and stats["peak_pages"] > 0
