"""Port parity for the GShard-style MoE (moonshot's 64-expert top-6 with a
dense first layer, arctic's top-2 with a dense residual) against
``repro`` on their smoke configs in fp32, with the same (JAX-initialised)
weights and the same numpy inputs: ``moe_apply`` under both dispatches,
with capacity drops and router ties, ``lm_apply``'s logits and aux loss,
and the ServeEngine's greedy streams against the JAX engine's."""
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
from repro_torch.common.params import from_jax_params  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.models import blocks as tb  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.serve import RequestState, ServeEngine  # noqa: E402

ARCHS = ["moonshot-v1-16b-a3b", "arctic-480b"]
# fp32 outputs: sums in another order (the repo's 2e-5); the aux loss is
# a mean of softmax probabilities, relative 1e-5
TOL = dict(atol=2e-5, rtol=2e-5)
AUX_RTOL = 1e-5


def _cfgs(arch, **kw):
    return (dataclasses.replace(jget(arch, smoke=True), compute_dtype=jnp.float32, **kw),
            tget(arch, smoke=True).with_overrides(compute_dtype=torch.float32, **kw))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # the CPU is shared with the other test workers: torch's intra-op pool
    # only contends for it at these sizes
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("case", ["plain", "drops", "tie"])
@pytest.mark.parametrize("impl", ["einsum", "gather"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches(arch, impl, case):
    """``drops``: capacity_factor 0.5 leaves each expert the floor of 4
    slots, so 10 tokens x top-k overflow some; ``tie``: two router
    columns equal, so every token's probabilities tie between experts 0
    and 1 and the lower index must win, as in jax.lax.top_k."""
    kw = {"moe_impl": impl}
    if case == "drops":
        kw["capacity_factor"] = 0.5
    jc, tc = _cfgs(arch, **kw)
    jp = init_params(jax.random.PRNGKey(1), jb.moe_specs(jc))
    if case == "tie":
        jp["router"] = jp["router"].at[:, 1].set(jp["router"][:, 0])
    tp = from_jax_params(jax.tree.map(np.asarray, jp), "cpu")
    x = _np(np.random.default_rng(2), (3, 10, jc.d_model))
    jy, jaux = jb.moe_apply(jc, jp, jnp.asarray(x))
    ty, taux = tb.moe_apply(tc, tp, torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=AUX_RTOL)
    if case == "drops":  # some choices did overflow the 4 slots
        _, idx, _ = tb._route(tc, tp, torch.from_numpy(x))
        pos, _ = tb._positions_in_expert(idx, tc.num_experts, 10)
        assert (pos >= tb._capacity(10, tc)).any()


@pytest.mark.parametrize("arch", ["minicpm3-4b"] + ARCHS)
def test_weights_carry_across_key_for_key(arch):
    """Every leaf of the MLA (kv_lora, q_lora) and MoE (experts,
    expert_mlp, router, dense residual) trees crosses from JAX with its
    key, shape, dtype and values, and lands where the port's own specs
    put it."""
    jc, tc = _cfgs(arch)
    jp = init_params(jax.random.PRNGKey(3), model_specs(jc))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), "cpu")
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    specs = tlm.lm_specs(tc)
    for path, leaf in flat:
        t, spec = tp, specs
        for k in path:
            t, spec = t[k.key], spec[k.key]
        assert tuple(t.shape) == tuple(spec.shape) == leaf.shape, jax.tree_util.keystr(path)
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))
    keys = {jax.tree_util.keystr(p) for p, _ in flat}
    want = ("wkv_a", "wq_b") if arch == "minicpm3-4b" else ("router", "w1")
    assert all(any(w in k for k in keys) for w in want)


def test_top_k_breaks_ties_like_jax():
    """Descending values, a tie going to the lower index, on inputs full
    of ties."""
    x = np.random.default_rng(4).integers(0, 4, (64, 16)).astype(np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 6)
    tv, ti = tb.top_k(torch.from_numpy(x), 6)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_apply_logits_and_aux_match(arch):
    """The whole stack: dense first layers with dense_ff (moonshot), MoE
    layers, the aux loss summed over them."""
    jc, tc = _cfgs(arch)
    jp = init_params(jax.random.PRNGKey(0), model_specs(jc))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), "cpu")
    tok = np.random.default_rng(6).integers(0, jc.vocab_size, (2, 12)).astype(np.int32)
    jl, _, jaux = jlm.lm_apply(jc, jp, jnp.asarray(tok), remat=False)
    tl, _, taux = tlm.lm_apply(tc, tp, torch.from_numpy(tok), remat=False)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=AUX_RTOL)
    assert float(jaux) > 0
    if arch.startswith("moonshot"):
        assert tp["head_layers"]["h0"]["c"]["w1"].shape == (tc.d_model, tc.dense_ff)


def _serve(eng, work):
    reqs = [eng.submit(p, max_new_tokens=int(g)) for p, g in work]
    eng.run_until_drained()
    return reqs


@pytest.mark.parametrize("arch,slots,chunk,layout", [
    ("moonshot-v1-16b-a3b", 2, 64, "paged"), ("moonshot-v1-16b-a3b", 2, 64, "contiguous"),
    ("moonshot-v1-16b-a3b", 4, 64, "paged"), ("moonshot-v1-16b-a3b", 4, 64, "contiguous"),
    ("moonshot-v1-16b-a3b", 2, None, "paged"), ("moonshot-v1-16b-a3b", 4, None, "contiguous"),
    ("arctic-480b", 4, 64, "paged"), ("arctic-480b", 2, None, "contiguous"),
    ("moonshot-v1-16b-a3b", 8, 64, "paged")])
def test_streams_match_jax_engine(arch, slots, chunk, layout):
    """Greedy streams token for token: every prefill chunk row is padded
    with token 0 in both engines, and the padding competes for its row's
    expert capacity alike.  A paged chunk runs only the rows that take
    tokens (JAX runs every slot), so at 8 slots routing is held per row."""
    jc, tc = _cfgs(arch)
    jp = init_params(jax.random.PRNGKey(0), model_specs(jc))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), "cpu")
    work = [(p, g) for _, p, g in mixed_workload(6, seed=2)]
    kw = dict(max_slots=slots, max_len=192, prefill_chunk_tokens=chunk, kv_layout=layout)
    want = _serve(JEngine(jc, params=jp, **kw), work)
    got = _serve(ServeEngine(tc, params=tp, device="cpu", **kw), work)
    assert all(r.state is RequestState.DONE for r in got)
    assert [r.tokens for r in got] == [r.tokens for r in want]
