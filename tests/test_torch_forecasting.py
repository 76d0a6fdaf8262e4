"""Port parity for the paper's 11 forecasting models, on the CPU: each
model's parameter tree, its forward on JAX's parameters (carried across
key for key with ``from_jax_params``) and 3 SGD steps of the bare-metal
loop (``launch.paper_tables.forecaster_step``) on the same batch indices,
against ``repro.models.forecasting`` and the step of
``benchmarks/paper_tables.py`` (``_train_forecaster``), at the JAX
package's widths (W 96, Hz 24, hidden 64) on JAX's ETT series."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import forecasting as JF  # noqa: E402
from repro_torch.common import prng  # noqa: E402
from repro_torch.common.params import from_jax_params, to_numpy, tree_leaves  # noqa: E402
from repro_torch.launch import paper_tables as P  # noqa: E402
from repro_torch.models import forecasting as TF  # noqa: E402

W, HZ, LR, BATCH, STEPS = 96, 24, 1e-3, 16, 3
NAMES = list(JF.MODELS)
# fp32 forwards: sums in another order (the repo's 2e-5)
FWD_TOL = dict(atol=2e-5, rtol=2e-5)
# losses and parameters after 3 SGD steps: 1e-4 relative, and an absolute
# floor for leaves that start at zero (biases move by lr x grad ~ 1e-4)
STEP_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def series():
    return np.array(JF.make_ett_series(4096, seed=0))  # writable


def _structure(tree):
    """Nested keys, list lengths and leaf shapes of a tree."""
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_structure(v) for v in tree]
    return tuple(tree.shape)


def _jax_params(name):
    init, _ = JF.MODELS[name](W, HZ)
    return init(jax.random.PRNGKey(NAMES.index(name)))


def _assert_trees(got, want, **tol):
    assert _structure(got) == _structure(want)
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        np.testing.assert_allclose(g, w, **tol)


@pytest.mark.parametrize("name", NAMES)
def test_init_matches_jax_tree(name):
    """The port's init gives JAX's tree, key for key and shape for shape,
    with JAX's scales: zero biases, weights of std 1/sqrt(fan in)."""
    t = TF.MODELS[name](W, HZ)[0](prng.PRNGKey(0), "cpu")
    j = jax.tree.map(np.asarray, _jax_params(name))
    assert _structure(t) == _structure(j)
    for leaf in tree_leaves(t):
        assert leaf.dtype == torch.float32 and leaf.device.type == "cpu"
        if leaf.ndim == 1:
            assert not leaf.any()
        else:
            assert abs(leaf.std().item() * np.sqrt(leaf.shape[0]) - 1) < 0.25


@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_jax(name, series):
    jp = _jax_params(name)
    x = np.random.default_rng(1).standard_normal((BATCH, W)).astype(np.float32)
    want = np.asarray(JF.MODELS[name](W, HZ)[1](jp, jnp.asarray(x)))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), "cpu")
    got = TF.MODELS[name](W, HZ)[1](tp, torch.from_numpy(x))
    assert got.shape == (BATCH, HZ)
    np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)


@pytest.mark.parametrize("name", NAMES)
def test_sgd_steps_match_jax(name, series):
    """3 steps of the bare-metal loop on the same batch indices: the loss
    of every step, then every parameter leaf, equal JAX's."""
    _, japply = JF.MODELS[name](W, HZ)
    split = 3 * len(series) // 4

    @jax.jit
    def jstep(params, starts):  # benchmarks/paper_tables.py's step
        idx = starts[:, None] + jnp.arange(W + HZ)[None, :]
        data = jnp.asarray(series)[idx]
        x, y = data[:, :W], data[:, W:]
        loss, g = jax.value_and_grad(
            lambda p: jnp.mean((japply(p, x) - y) ** 2))(params)
        return jax.tree.map(lambda p, gg: p - LR * gg, params, g), loss

    jp = _jax_params(name)
    tp = P._trainable(from_jax_params(jax.tree.map(np.asarray, jp), "cpu"))
    tapply = TF.MODELS[name](W, HZ)[1]
    rng = np.random.default_rng(2)
    for _ in range(STEPS):
        starts = rng.integers(0, split - W - HZ, BATCH).astype(np.int32)
        jp, jloss = jstep(jp, jnp.asarray(starts))
        tloss = P.forecaster_step(tapply, tp, torch.from_numpy(series),
                                  torch.from_numpy(starts).long(), W, HZ, LR)
        np.testing.assert_allclose(tloss.item(), float(jloss), **STEP_TOL)
    _assert_trees(to_numpy(tp), jax.tree.map(np.asarray, jp), **STEP_TOL)


def test_moving_average_matches_jax():
    x = np.random.default_rng(3).standard_normal((4, W)).astype(np.float32)
    np.testing.assert_allclose(TF._moving_avg(torch.from_numpy(x)).numpy(),
                               np.asarray(JF._moving_avg(jnp.asarray(x))),
                               **FWD_TOL)


def test_ett_series_is_seeded_and_standardized():
    a = TF.make_ett_series(4096, seed=0, device="cpu")
    assert a.shape == (4096,) and a.dtype == torch.float32
    assert torch.equal(a, TF.make_ett_series(4096, seed=0, device="cpu"))
    assert not torch.equal(a, TF.make_ett_series(4096, seed=1, device="cpu"))
    assert abs(a.mean().item()) < 1e-5
    assert abs(a.std(correction=0).item() - 1) < 1e-5
    # the same deterministic seasonality as JAX's series: they differ by
    # the noise only (0.2 x N(0, 1) before the standardization)
    j = np.asarray(JF.make_ett_series(4096, seed=0))
    assert np.corrcoef(a.numpy(), j)[0, 1] > 0.9
