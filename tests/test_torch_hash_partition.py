"""Port parity for the hash-partition kernel's plain version, on the CPU:
the hash, the per-block histograms and ``partition_order`` against the
Pallas kernel in interpret mode and the jnp oracles, bitwise (counts and
orders are integers); and the ops dispatch.  The CUDA kernel itself runs
only on the card (tests/test_torch_cuda.py)."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import hash_partition as jhp  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import hash_partition as thp  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

EXTREMES = np.array([-1, 0, 1, 2 ** 31 - 1, -2 ** 31, 2047, 2048, -2048], np.int32)


def _keys(n, seed, lo=-2 ** 31, hi=2 ** 31):
    rng = np.random.default_rng(seed)
    keys = rng.integers(lo, hi, n, dtype=np.int64).astype(np.int32)
    keys[:min(n, len(EXTREMES))] = EXTREMES[:n]
    return keys


def test_plain_hash_matches_jax_bitwise():
    keys = _keys(200_000, 0)
    want = np.asarray(jref.hash_u32_ref(jnp.asarray(keys))).astype(np.int64)
    np.testing.assert_array_equal(tref.hash_u32_ref(torch.from_numpy(keys)).numpy(), want)
    # int64 keys hash by their low 32 bits, as JAX's astype(uint32)
    wide = keys.astype(np.int64) + (np.int64(3) << 40)
    np.testing.assert_array_equal(tref.hash_u32_ref(torch.from_numpy(wide)).numpy(), want)


@pytest.mark.parametrize("block", [512, 2048])
@pytest.mark.parametrize("p", [4, 16, 64])
@pytest.mark.parametrize("n", [100, 511, 512, 513, 5000])
def test_plain_histogram_matches_pallas_interpret(n, p, block):
    keys = _keys(n, n * 7 + p, 0, 10_000) if n % 2 else _keys(n, n + p)
    want = jhp.hash_partition_histogram(jnp.asarray(keys), num_buckets=p,
                                        block=block, interpret=True)
    got = thp.hash_partition_histogram_plain(torch.from_numpy(keys),
                                             num_buckets=p, block=block)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    total = jref.hash_partition_histogram_ref(jnp.asarray(keys), num_buckets=p)
    np.testing.assert_array_equal(
        tref.hash_partition_histogram_ref(torch.from_numpy(keys), num_buckets=p).numpy(),
        np.asarray(total))


def test_plain_histogram_batches_rows():
    """[R, N] keys give each row's [nb, P] histograms."""
    keys = torch.from_numpy(_keys(3 * 1000, 5).reshape(3, 1000))
    got = thp.hash_partition_histogram_plain(keys, num_buckets=8, block=256)
    assert got.shape == (3, 4, 8)
    for r in range(3):
        assert torch.equal(got[r], thp.hash_partition_histogram_plain(
            keys[r], num_buckets=8, block=256))


@pytest.mark.parametrize("n,p", [(5000, 16), (2049, 4), (100, 64)])
def test_partition_order_matches_jax(n, p):
    keys = _keys(n, n + p)
    jorder, joffsets = jhp.partition_order(jnp.asarray(keys), p, interpret=True)
    torder, toffsets = thp.partition_order(torch.from_numpy(keys), p)
    np.testing.assert_array_equal(torder.numpy(), np.asarray(jorder))
    np.testing.assert_array_equal(toffsets.numpy(), np.asarray(joffsets))
    assert toffsets.dtype == torch.int32


@pytest.mark.parametrize("impl", ["auto", "ref"])
def test_ops_dispatch(impl):
    """Per-block [nb, P] on every impl (JAX's "ref" gives the global
    histogram as one block instead)."""
    keys = _keys(3000, 9)
    got = ops.hash_partition_histogram(torch.from_numpy(keys), num_buckets=16,
                                       impl=impl, block=1024)
    want = jhp.hash_partition_histogram(jnp.asarray(keys), num_buckets=16,
                                        block=1024, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ops_dispatch_refuses_cpu_kernel_and_unknown_impl():
    keys = torch.zeros(10, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        ops.hash_partition_histogram(keys, num_buckets=4, impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        ops.hash_partition_histogram(keys, num_buckets=4, impl="pallas")
    before = thp.hash_partition_histogram_kernel.launches
    ops.hash_partition_histogram(keys, num_buckets=4)  # CPU: the plain version
    assert thp.hash_partition_histogram_kernel.launches == before
