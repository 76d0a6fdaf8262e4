"""Port parity for the seeded draws (``repro_torch.common.prng``) against
``jax.random`` on the CPU: keys, ``split``, ``fold_in``, bits and
``randint`` exactly; ``uniform`` bitwise; ``normal`` and ``erf_inv``
within 2 float32 ulps of JAX's (``jax.lax.erf_inv`` on a dense grid is the
judge); the keys also against a numpy threefry written here.  Then what
the paper's pipelines draw: ``make_ett_series`` and ``make_camels_like``
within 1e-5 of JAX's, every forecasting model's and the LSTM's initial
parameters within 2 ulps, and the batch-index chains of
``launch/paper_tables.py`` exactly."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import forecasting as JF  # noqa: E402
from repro.models import hydrology as JH  # noqa: E402
from repro_torch.common import prng  # noqa: E402
from repro_torch.models import forecasting as TF  # noqa: E402
from repro_torch.models import hydrology as TH  # noqa: E402

# seeds at 0, small, and past 2^31 and 2^32 (JAX keeps the low 32 bits)
SEEDS = [0, 1, 7, 12345, 2 ** 31 + 3, 2 ** 33 + 5]
ULPS = 2           # normal draws and initial parameters
SERIES_TOL = 1e-5  # the standardized series


def _ulps(a, b) -> int:
    """Largest distance in float32 ulps (ordered integer images)."""
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int(np.abs(ordered(a) - ordered(b)).max()) if np.size(a) else 0


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.uint32)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_split_fold_in_and_bits_match_jax(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(_u32(tk), np.asarray(jk))
    for num in (2, 3, 6):
        np.testing.assert_array_equal(_u32(prng.split(tk, num)),
                                      np.asarray(jax.random.split(jk, num)))
    for data in (0, 1, 2, 77, 2 ** 32 - 1):
        np.testing.assert_array_equal(_u32(prng.fold_in(tk, data)),
                                      np.asarray(jax.random.fold_in(jk, data)))
    for shape in ((5,), (3, 7), (2, 3, 4)):
        np.testing.assert_array_equal(_u32(prng.random_bits(tk, shape)),
                                      np.asarray(jax.random.bits(jk, shape)))
    # a batch of keys is jax.vmap over them
    keys = prng.split(tk, 4)
    want = jax.vmap(lambda k: jax.random.bits(k, (9,)))(jax.random.split(jk, 4))
    np.testing.assert_array_equal(_u32(prng.random_bits(keys, 9)), np.asarray(want))


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_uniform_matches_jax_bitwise(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    for lo, hi in ((0.0, 1.0), (-1.0, 1.0), (2.5, 7.0), (-3.0, -1.0)):
        want = np.asarray(jax.random.uniform(jk, (31, 17), minval=lo, maxval=hi))
        got = prng.uniform(tk, (31, 17), lo, hi).numpy()
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_matches_jax(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    want = np.asarray(jax.random.normal(jk, (256, 300)))
    got = prng.normal(tk, (256, 300)).numpy()
    assert got.dtype == np.float32
    assert _ulps(got, want) <= ULPS


def test_erf_inv_matches_xla_on_a_dense_grid():
    x = np.linspace(-1.0, 1.0, 1_000_001, dtype=np.float32)
    x = np.concatenate([x, np.random.default_rng(0).uniform(-1, 1, 500_000)
                        .astype(np.float32)])
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    got = prng.erf_inv(torch.from_numpy(x)).numpy()
    finite = np.isfinite(want)
    np.testing.assert_array_equal(got[~finite], want[~finite])  # +-inf at +-1
    assert _ulps(got[finite], want[finite]) <= ULPS


@pytest.mark.parametrize("lo,hi", [(0, 2928), (0, 1400), (-50, 50), (5, 5),
                                   (9, 3), (0, 2 ** 31 - 1), (-2 ** 31, 2 ** 31 - 1)])
def test_randint_matches_jax(lo, hi):
    for seed in SEEDS[:4]:
        jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
        want = np.asarray(jax.random.randint(jk, (513,), lo, hi))
        got = prng.randint(tk, 513, lo, hi)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def _threefry_np(k1, k2, x1, x2):
    """threefry2x32 in numpy uint32 (wrapping) arithmetic."""
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))
    ks = (np.uint32(k1), np.uint32(k2), np.uint32(k1 ^ k2 ^ 0x1BD11BDA))
    x1, x2 = np.uint32(x1) + ks[0], np.uint32(x2) + ks[1]
    for i in range(5):
        for r in rot[i % 2]:
            x1 = x1 + x2
            x2 = ((x2 << np.uint32(r)) | (x2 >> np.uint32(32 - r))) ^ x1
        x1 = x1 + ks[(i + 1) % 3]
        x2 = x2 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x1, x2


def test_keys_match_a_numpy_threefry():
    """The key tree of the pipelines (PRNGKey, split, fold_in) against
    threefry written independently of both packages."""
    with np.errstate(over="ignore"):
        for seed in SEEDS:
            key = (0, seed & 0xFFFFFFFF)
            np.testing.assert_array_equal(_u32(prng.PRNGKey(seed)), key)
            want = [_threefry_np(*key, 0, i) for i in range(5)]
            np.testing.assert_array_equal(_u32(prng.split(prng.PRNGKey(seed), 5)),
                                          np.array(want, np.uint32))
            np.testing.assert_array_equal(_u32(prng.fold_in(prng.PRNGKey(seed), 3)),
                                          np.array(want[3], np.uint32))


@pytest.mark.parametrize("seed", [0, 3])
def test_ett_series_matches_jax(seed):
    got = TF.make_ett_series(4096, seed=seed, device="cpu").numpy()
    want = np.asarray(JF.make_ett_series(4096, seed=seed))
    np.testing.assert_allclose(got, want, rtol=0, atol=SERIES_TOL)


def test_camels_like_matches_jax():
    feats, targets = TH.make_camels_like(2000, seed=0, device="cpu")
    jf, jt = JH.make_camels_like(2000, seed=0)
    np.testing.assert_allclose(feats.numpy(), np.asarray(jf), rtol=0, atol=SERIES_TOL)
    assert list(targets) == list(jt)
    for name, y in targets.items():
        np.testing.assert_allclose(y.numpy(), np.asarray(jt[name]), rtol=0,
                                   atol=SERIES_TOL, err_msg=name)


def _assert_params(got, want, path="params"):
    """The two trees key for key, every leaf within ULPS."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_params(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_params(g, w, f"{path}[{i}]")
    else:
        assert tuple(got.shape) == want.shape, path
        assert _ulps(got.numpy(), np.asarray(want)) <= ULPS, path


@pytest.mark.parametrize("name", list(JF.MODELS))
def test_forecasting_init_matches_jax(name):
    seed = list(JF.MODELS).index(name)
    want = JF.MODELS[name](96, 24)[0](jax.random.PRNGKey(seed))
    got = TF.MODELS[name](96, 24)[0](prng.PRNGKey(seed), "cpu")
    _assert_params(got, want)


def test_lstm_init_matches_jax():
    for seed in (0, 1):
        want = JH.lstm_init(jax.random.PRNGKey(seed))
        got = TH.lstm_init(prng.PRNGKey(seed), device="cpu")
        assert list(got) == list(want)
        for k in want:
            assert _ulps(got[k].numpy(), np.asarray(want[k])) <= ULPS, k


def test_paper_batch_chains_match_jax():
    """``key, sub = split(key)`` then ``randint(sub, ...)`` per step, as
    both packages' Table 3 and Table 1 loops draw their batches."""
    for seed, n, hi in ((1, 128, 3072 - 120), (1, 64, 1400)):
        jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
        for _ in range(4):
            jk, jsub = jax.random.split(jk)
            tk, tsub = prng.split(tk)
            np.testing.assert_array_equal(
                prng.randint(tsub, n, 0, hi).numpy(),
                np.asarray(jax.random.randint(jsub, (n,), 0, hi)))
