"""The port's checkpoint store against ``repro.checkpoint.store`` on the
CPU: a step written by either package restores in the other bitwise
(fp32, bf16 and int32 leaves, and a whole train state), torn steps are
skipped, and ``AsyncCheckpointer`` round-trips a snapshot."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402
import os  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jcfg  # noqa: E402
import repro_torch.configs as tcfg  # noqa: E402
from repro.checkpoint import store as jstore  # noqa: E402
from repro.train import state as jstate  # noqa: E402
from repro_torch.checkpoint import store as tstore  # noqa: E402
from repro_torch.common.params import from_jax_params, tree_leaves  # noqa: E402
from repro_torch.train import state as tstate  # noqa: E402


def _jax_tree(seed):
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": jnp.asarray(rng.standard_normal((4, 5)).astype(np.float32)),
                   "emb": jnp.asarray(rng.standard_normal((3, 7)), jnp.bfloat16)},
        "opt": {"w": {"m": jnp.asarray(rng.standard_normal((4, 5)).astype(np.float32))}},
        "step": jnp.asarray(seed + 17, jnp.int32),
    }


def _bits(x):
    """A leaf's exact bit pattern and dtype name, from either package."""
    if isinstance(x, torch.Tensor):
        name = str(x.dtype).removeprefix("torch.")
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return name, x.numpy().tobytes(), tuple(x.shape)
    a = np.asarray(x)
    return a.dtype.name, a.tobytes(), a.shape


def _assert_bitwise(port_tree, jax_tree):
    flat = jax.tree_util.tree_flatten_with_path(jax_tree)[0]
    assert len(flat) == len(tree_leaves(port_tree))
    for path, leaf in flat:
        t = port_tree
        for k in path:
            t = t[k.key]
        assert _bits(t) == _bits(leaf), jax.tree_util.keystr(path)


def test_jax_step_restores_in_the_port_bitwise(tmp_path):
    want = _jax_tree(1)
    jstore.save(str(tmp_path), 3, want)
    like = from_jax_params(jax.tree.map(np.asarray, _jax_tree(2)), "cpu")
    got = tstore.restore(str(tmp_path), like)
    _assert_bitwise(got, want)
    assert got["params"]["emb"].dtype == torch.bfloat16
    assert got["step"].dtype == torch.int32 and got["step"].shape == ()


def test_port_step_restores_in_jax_bitwise(tmp_path):
    src = _jax_tree(4)
    state = from_jax_params(jax.tree.map(np.asarray, src), "cpu")
    tstore.save(str(tmp_path), 5, state)
    assert jstore.verify_step(str(tmp_path), 5)
    got = jstore.restore(str(tmp_path), _jax_tree(6))
    _assert_bitwise(state, got)
    assert got["params"]["emb"].dtype == jnp.bfloat16


def test_train_state_round_trips_across_packages(tmp_path):
    """The real train-state tree (AdamW): keys, shapes and bits agree
    between the packages both ways."""
    jcf = dataclasses.replace(jcfg.get_config("tinyllama-1.1b", smoke=True),
                              param_dtype=jnp.bfloat16)
    js = jstate.init_train_state(jax.random.PRNGKey(0), jcf, jcfg.RunConfig())
    jstore.save(str(tmp_path / "j"), 1, js)
    tcf = tcfg.get_config("tinyllama-1.1b", smoke=True).with_overrides(
        param_dtype=torch.bfloat16)
    like = tstate.init_train_state(torch.Generator().manual_seed(1), tcf,
                                   tcfg.RunConfig(), device="cpu")
    ts = tstore.restore(str(tmp_path / "j"), like)
    _assert_bitwise(ts, js)
    tstore.save(str(tmp_path / "t"), 1, ts)
    _assert_bitwise(ts, jstore.restore(str(tmp_path / "t"), js))


def _tear_leaf(directory, step):
    path = os.path.join(directory, f"step_{step:08d}")
    victim = sorted(f for f in os.listdir(path) if f != "manifest.json")[0]
    with open(os.path.join(path, victim), "r+b") as f:
        f.truncate(3)


def test_latest_step_skips_a_torn_step(tmp_path):
    d = str(tmp_path)
    first = from_jax_params(jax.tree.map(np.asarray, _jax_tree(7)), "cpu")
    tstore.save(d, 1, first)
    tstore.save(d, 2, from_jax_params(jax.tree.map(np.asarray, _jax_tree(8)), "cpu"))
    assert tstore.latest_step(d) == 2
    _tear_leaf(d, 2)
    assert not tstore.verify_step(d, 2)
    with pytest.warns(RuntimeWarning, match="torn"):
        assert tstore.latest_step(d) == 1
    assert tstore.latest_step(d, verify=False) == 2
    with pytest.warns(RuntimeWarning, match="torn"):
        got = tstore.restore(d, first)
    assert int(got["step"]) == int(first["step"])
    torch.testing.assert_close(got["params"]["w"], first["params"]["w"], rtol=0, atol=0)
    with pytest.raises(tstore.CheckpointCorrupt):
        tstore.restore(d, first, step=2)
    with pytest.warns(RuntimeWarning, match="torn"):  # JAX agrees
        assert jstore.latest_step(d) == 1


def test_async_checkpointer_round_trips_a_snapshot(tmp_path):
    d = str(tmp_path)
    state = from_jax_params(jax.tree.map(np.asarray, _jax_tree(9)), "cpu")
    want = {k: v.clone() for k, v in state["params"].items()}
    ck = tstore.AsyncCheckpointer(d, keep=2)
    ck.save(1, state)
    state["params"]["w"].add_(1.0)  # an in-place train step after the snapshot
    ck.save(2, state)
    ck.save(3, state)
    ck.wait()
    ck.close()
    assert sorted(os.listdir(d)) == ["step_00000002", "step_00000003"]
    got = tstore.restore(d, state, step=2)
    torch.testing.assert_close(got["params"]["w"], want["w"] + 1.0, rtol=0, atol=0)
    torch.testing.assert_close(got["params"]["emb"], want["emb"], rtol=0, atol=0)
    ck1 = tstore.AsyncCheckpointer(d, keep=5)
    snap = from_jax_params(jax.tree.map(np.asarray, _jax_tree(10)), "cpu")
    ck1.save(4, snap)
    snap["params"]["w"].zero_()
    ck1.close()
    _assert_bitwise(tstore.restore(d, snap), _jax_tree(10))
