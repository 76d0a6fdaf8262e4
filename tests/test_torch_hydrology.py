"""Port parity for the hydrology LSTM (paper Tables 1-2), on the CPU: the
forward on JAX's parameters and 3 SGD steps of the bare-metal loop
(``launch.paper_tables.hydrology_step``) on the same batch indices
against ``repro.models.hydrology`` and the step of
``benchmarks/paper_tables.py`` (``bench_hydrology``); ``nse`` / ``nnse``;
``window_dataset`` on JAX's basin; ``make_camels_like``'s shapes,
standardisation and bucket recursion."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import hydrology as JH  # noqa: E402
from repro_torch.common import prng  # noqa: E402
from repro_torch.common.params import from_jax_params, to_numpy  # noqa: E402
from repro_torch.launch import paper_tables as P  # noqa: E402
from repro_torch.models import hydrology as TH  # noqa: E402

WINDOW, BATCH, STEPS, LR = 64, 16, 3, 3e-3
FWD_TOL = dict(atol=2e-5, rtol=2e-5)  # the repo's fp32 tolerance
STEP_TOL = dict(rtol=1e-4, atol=1e-6)  # as in test_torch_forecasting.py


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def basin():
    """JAX's basin and its windows, as numpy."""
    feats, targets = JH.make_camels_like(400, seed=0)
    x, y = JH.window_dataset(feats, targets, WINDOW)
    return (np.array(feats), {k: np.array(v) for k, v in targets.items()},
            np.array(x), np.array(y))


def test_lstm_init_matches_jax_tree():
    t = TH.lstm_init(prng.PRNGKey(0), device="cpu")
    j = JH.lstm_init(jax.random.PRNGKey(0))
    assert list(t) == list(j)
    assert {k: tuple(v.shape) for k, v in t.items()} == \
        {k: tuple(v.shape) for k, v in j.items()}
    nh = t["wh"].shape[0]
    np.testing.assert_array_equal(t["b"].numpy(), np.asarray(j["b"]))  # forget bias 1
    assert t["b"][nh:2 * nh].eq(1).all() and not t["head_b"].any()


def test_lstm_forward_matches_jax(basin):
    _, _, x, _ = basin
    jp = JH.lstm_init(jax.random.PRNGKey(0))
    want = np.asarray(JH.lstm_apply(jp, jnp.asarray(x[:BATCH])))
    got = TH.lstm_apply(from_jax_params(jax.tree.map(np.asarray, jp), "cpu"),
                        torch.from_numpy(x[:BATCH]))
    assert got.shape == (BATCH, len(TH.TARGETS))
    np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)


def test_lstm_sgd_steps_match_jax(basin):
    _, _, x_all, y_all = basin

    @jax.jit
    def jstep(params, idx):  # benchmarks/paper_tables.py's step
        x, y = jnp.asarray(x_all)[idx], jnp.asarray(y_all)[idx]
        loss, g = jax.value_and_grad(
            lambda p: jnp.mean((JH.lstm_apply(p, x) - y) ** 2))(params)
        return jax.tree.map(lambda p, gg: p - LR * gg, params, g), loss

    jp = JH.lstm_init(jax.random.PRNGKey(1))
    tp = P._trainable(from_jax_params(jax.tree.map(np.asarray, jp), "cpu"))
    tx, ty = torch.from_numpy(x_all), torch.from_numpy(y_all)
    rng = np.random.default_rng(0)
    for _ in range(STEPS):
        idx = rng.integers(0, len(x_all), BATCH).astype(np.int32)
        jp, jloss = jstep(jp, jnp.asarray(idx))
        tloss = P.hydrology_step(tp, tx, ty, torch.from_numpy(idx).long(), LR)
        np.testing.assert_allclose(tloss.item(), float(jloss), **STEP_TOL)
    got = to_numpy(tp)
    for k, v in jp.items():
        np.testing.assert_allclose(got[k], np.asarray(v), **STEP_TOL)


def test_nse_and_nnse_match_jax():
    rng = np.random.default_rng(4)
    obs = rng.standard_normal(500).astype(np.float32)
    pred = (obs + 0.3 * rng.standard_normal(500)).astype(np.float32)
    for fn in ("nse", "nnse"):
        want = float(getattr(JH, fn)(jnp.asarray(pred), jnp.asarray(obs)))
        got = float(getattr(TH, fn)(torch.from_numpy(pred), torch.from_numpy(obs)))
        assert abs(got - want) <= 1e-6, (fn, got, want)
    # a perfect prediction: NSE 1, NNSE 1; predicting the mean: NSE 0, NNSE 0.5
    o = torch.from_numpy(obs)
    assert float(TH.nse(o, o)) == 1.0 and float(TH.nnse(o, o)) == 1.0
    assert abs(float(TH.nnse(torch.full_like(o, float(o.mean())), o)) - 0.5) < 1e-6


def test_window_dataset_exact_on_jax_series(basin):
    feats, targets, x, y = basin
    tx, ty = TH.window_dataset(torch.from_numpy(feats),
                               {k: torch.from_numpy(v) for k, v in targets.items()},
                               WINDOW)
    np.testing.assert_array_equal(tx.numpy(), x)
    np.testing.assert_array_equal(ty.numpy(), y)


def test_bucket_recursion_matches_jax_scan():
    """The sequential bucket model on the host against the JAX package's
    ``lax.scan`` of the same cell on fixed forcings."""
    rng = np.random.default_rng(5)
    prcp = np.maximum(rng.standard_normal(2000), 0).astype(np.float32)
    melt = (0.2 * np.maximum(rng.standard_normal(2000), 0)).astype(np.float32)

    def bucket(storage, p_m):  # repro/models/hydrology.py's cell
        p, m = p_m
        storage = storage + p + m
        q = 0.06 * storage
        return storage - q, q

    _, want = jax.lax.scan(bucket, jnp.asarray(5.0), (jnp.asarray(prcp), jnp.asarray(melt)))
    np.testing.assert_allclose(TH.bucket_flow(prcp, melt), np.asarray(want),
                               rtol=1e-6, atol=1e-6)


def test_make_camels_like_shapes_and_standardization():
    feats, targets = TH.make_camels_like(2000, seed=0, device="cpu")
    jf, jt = JH.make_camels_like(2000, seed=0)
    assert feats.shape == jf.shape == (2000, TH.N_FEATURES)
    assert feats.dtype == torch.float32 and list(targets) == list(jt)
    for col in (feats.T, *targets.values()):
        for c in (col if col.ndim == 2 else [col]):
            assert abs(c.mean().item()) < 1e-4
            assert abs(c.std(correction=0).item() - 1) < 1e-4
    again, _ = TH.make_camels_like(2000, seed=0, device="cpu")
    assert torch.equal(feats, again)
    # the streamflow follows the bucket: it lags the precipitation, so
    # both packages' series correlate alike with it
    for pkg_feats, pkg_t in ((feats.numpy(), {k: v.numpy() for k, v in targets.items()}),
                             (np.asarray(jf), {k: np.asarray(v) for k, v in jt.items()})):
        assert np.corrcoef(pkg_feats[:, 0], pkg_t["precipitation"])[0, 1] > 0.99
        assert np.corrcoef(pkg_t["streamflow"][1:], pkg_t["precipitation"][:-1])[0, 1] > 0.0
