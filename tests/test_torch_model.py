"""Port parity: the model blocks and one chunked-prefill step and one
decode step of ``lm_apply`` on the paged cache, against ``repro`` on the
tinyllama smoke config in fp32 with the same (JAX-initialised) weights."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.common.params import init_params, is_param  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.models import blocks as jb  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.train.state import model_specs as jspecs  # noqa: E402
from repro_torch.common.params import Param as TParam  # noqa: E402
from repro_torch.common.params import from_jax_params, map_tree  # noqa: E402
from repro_torch.common.params import init_params as tinit_params  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.models import blocks as tb  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402

TOL = dict(atol=2e-5, rtol=2e-5)
JCFG = dataclasses.replace(jget("tinyllama-1.1b", smoke=True), compute_dtype=jnp.float32)
TCFG = tget("tinyllama-1.1b", smoke=True).with_overrides(compute_dtype=torch.float32)


@pytest.fixture(scope="module")
def params():
    jp = init_params(jax.random.PRNGKey(0), jspecs(JCFG))
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # the CPU is shared with the other test workers: torch's intra-op pool
    # only contends for it at these sizes
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_from_jax_params_is_key_for_key(params):
    jp, tp = params
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat_j) > 5
    for path, leaf in flat_j:
        t = tp
        for k in path:
            t = t[k.key]
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))


def test_rmsnorm_matches(params):
    jp, tp = params
    x = _x(np.random.default_rng(0), (2, 5, JCFG.d_model))
    p_j = jp["unit"]["b0"]["t"]["norm"]
    p_j = {"scale": p_j["scale"][0] * 1.5}
    want = jb.rmsnorm_apply(p_j, jnp.asarray(x), JCFG.norm_eps)
    got = tb.rmsnorm_apply({"scale": torch.from_numpy(np.array(p_j["scale"]))},
                           torch.from_numpy(x), TCFG.norm_eps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_rope_matches():
    rng = np.random.default_rng(1)
    x = _x(rng, (2, 6, 4, 16))
    pos = rng.integers(0, 500, (2, 6)).astype(np.int32)
    want = jb.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    got = tb.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_mlp_matches(params):
    jp, tp = params
    x = _x(np.random.default_rng(2), (2, 3, JCFG.d_model))
    pj = jax.tree.map(lambda a: a[0], jp["unit"]["b0"]["c"])
    pt = map_tree(lambda a: a[0], tp["unit"]["b0"]["c"])
    want = jb.mlp_apply(JCFG, pj, jnp.asarray(x))
    got = tb.mlp_apply(TCFG, pt, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_lm_prefill_then_decode_matches(params):
    """One ragged chunked-prefill step (rows at different bases, an inert
    row, sentinel table entries), then one decode step: logits and pools
    against the JAX model."""
    jp, tp = params
    rng = np.random.default_rng(3)
    page, num_pages, max_pages = 4, 12, 4
    B, T = 3, 8
    jcache = jax.tree.map(
        lambda p: jnp.asarray(_x(rng, p.shape)),
        jlm.lm_paged_cache_specs(JCFG, num_pages, page), is_leaf=is_param)
    tcache = from_jax_params(jax.tree.map(np.asarray, jcache), "cpu")
    bt = np.array([[4, 9, 1, num_pages], [0, 7, 3, 11], [num_pages] * 4], np.int32)
    tokens = rng.integers(1, JCFG.vocab_size, (B, T)).astype(np.int32)
    base = np.array([0, 5, 0], np.int32)
    clens = np.array([8, 6, 0], np.int32)

    jl, jcache, _ = jlm.lm_apply(JCFG, jp, jnp.asarray(tokens), None, jcache,
                                 jnp.asarray(base), block_table=jnp.asarray(bt),
                                 chunk_lens=jnp.asarray(clens), remat=False)
    tl, tcache, _ = tlm.lm_apply(TCFG, tp, torch.from_numpy(tokens), None, tcache,
                                 torch.from_numpy(base), block_table=torch.from_numpy(bt),
                                 chunk_lens=torch.from_numpy(clens))
    valid = np.arange(T)[None, :] < clens[:, None]
    np.testing.assert_allclose(tl.numpy()[valid], np.asarray(jl)[valid], **TOL)
    _assert_pools(tcache, jcache)

    lens = base + clens
    step_tok = rng.integers(1, JCFG.vocab_size, (B, 1)).astype(np.int32)
    bt_dec = bt.copy()
    bt_dec[2] = num_pages  # free slot: its junk append must drop
    jl, jcache, _ = jlm.lm_apply(JCFG, jp, jnp.asarray(step_tok), None, jcache,
                                 jnp.asarray(lens), block_table=jnp.asarray(bt_dec),
                                 remat=False)
    tl, tcache, _ = tlm.lm_apply(TCFG, tp, torch.from_numpy(step_tok), None, tcache,
                                 torch.from_numpy(lens),
                                 block_table=torch.from_numpy(bt_dec))
    np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2], **TOL)
    _assert_pools(tcache, jcache)


def _assert_pools(tcache, jcache):
    for kind in ("k_pages", "v_pages"):
        np.testing.assert_allclose(tcache["unit"]["b0"][kind].numpy(),
                                   np.asarray(jcache["unit"]["b0"][kind]), **TOL)


def test_init_params_defaults_to_the_card(monkeypatch):
    """device=None means the card and raises without one (as
    launch/mesh.resolve_device); only an explicit "cpu" builds on the CPU."""
    spec = {"w": TParam((2, 3), (None, None))}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tinit_params(torch.Generator().manual_seed(0), spec)
    w = tinit_params(torch.Generator().manual_seed(0), spec, "cpu")["w"]
    assert w.device.type == "cpu" and w.shape == (2, 3)
