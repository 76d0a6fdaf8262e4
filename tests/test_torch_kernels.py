"""Port parity: the plain versions of the paged kernels (``repro_torch``)
against the JAX Pallas kernels in interpret mode and the jnp oracles, on
the sweeps of tests/test_kernels.py and tests/test_prefill_kernel.py; the
cache scatters exactly; and the ops dispatch.  The CUDA kernels themselves
run only on the card (tests/test_torch_cuda.py)."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import paged_scatter_cases as sc  # noqa: E402

from repro.kernels import decode_attention as jda  # noqa: E402
from repro.kernels import prefill_attention as jpa  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro_torch.kernels import decode_attention as tda  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import prefill_attention as tpa  # noqa: E402

TOL = dict(atol=2e-5, rtol=2e-5)  # fp32, as tests/test_kernels.py


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _paged(rng, B, H, KV, S, D, page, sentinel_tail=True):
    """q, scrambled pools and table covering [B, S]; spare pages unused;
    when asked, table entries past each row's length become sentinels."""
    mp = S // page
    num_pages = B * mp + 3
    q = _normal(rng, (B, H, D))
    kp = _normal(rng, (num_pages, page, KV, D))
    vp = _normal(rng, (num_pages, page, KV, D))
    bt = rng.permutation(num_pages)[:B * mp].reshape(B, mp).astype(np.int32)
    lens = rng.integers(1, S + 1, B).astype(np.int32)
    if sentinel_tail:
        for b in range(B):
            bt[b, -(-lens[b] // page):] = num_pages + b
    return q, kp, vp, bt, lens


# -- decode --------------------------------------------------------------------


@pytest.mark.parametrize("B,H,KV,S,D,page", [
    (2, 8, 2, 256, 64, 64),    # GQA 4x
    (1, 4, 4, 128, 32, 32),    # MHA
    (4, 16, 1, 512, 64, 128),  # MQA
    (2, 4, 4, 128, 48, 32),    # MLA-expanded layout
    (3, 32, 4, 256, 64, 16),   # tinyllama width, serving page size
    (4, 8, 2, 128, 16, 16),    # tinyllama smoke width
])
def test_decode_plain_matches_pallas(B, H, KV, S, D, page):
    rng = np.random.default_rng(B * 100 + D)
    q, kp, vp, bt, lens = _paged(rng, B, H, KV, S, D, page)
    want = jda.decode_attention_paged(*(jnp.asarray(a) for a in (q, kp, vp, bt, lens)),
                                      interpret=True)
    got = tda.decode_attention_paged_plain(*(torch.from_numpy(a) for a in
                                             (q, kp, vp, bt, lens)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # and the jnp oracle (which agrees wherever cache_len >= 1)
    oracle = jref.decode_attention_paged_ref(
        *(jnp.asarray(a) for a in (q, kp, vp, bt, lens)))
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **TOL)


@pytest.mark.parametrize("lens", [
    [64, 128, 192],      # exactly on page boundaries
    [65, 127, 256],      # straddling
    [1, 32, 255],
])
def test_decode_plain_page_edges(lens):
    rng = np.random.default_rng(9)
    q, kp, vp, bt, _ = _paged(rng, 3, 8, 2, 256, 32, 64, sentinel_tail=False)
    lens = np.asarray(lens, np.int32)
    want = jda.decode_attention_paged(*(jnp.asarray(a) for a in (q, kp, vp, bt, lens)),
                                      interpret=True)
    got = tda.decode_attention_paged_plain(*(torch.from_numpy(a) for a in
                                             (q, kp, vp, bt, lens)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_decode_sentinels_ignored():
    """Whatever the clamped sentinel page holds, it must not contribute."""
    rng = np.random.default_rng(11)
    q, kp, vp, bt, _ = _paged(rng, 2, 4, 2, 256, 32, 64, sentinel_tail=False)
    lens = torch.tensor([64, 128], dtype=torch.int32)
    args = [torch.from_numpy(a) for a in (q, kp, vp)]
    full = tda.decode_attention_paged_plain(*args, torch.from_numpy(bt), lens)
    bt_s = bt.copy()
    bt_s[0, 1:] = kp.shape[0]
    bt_s[1, 2:] = kp.shape[0] + 7
    got = tda.decode_attention_paged_plain(*args, torch.from_numpy(bt_s), lens)
    np.testing.assert_allclose(got.numpy(), full.numpy(), **TOL)


def test_decode_empty_row_is_zero():
    """cache_len == 0 gives zeros, as the Pallas kernel does (the jnp
    oracle returns the mean of V instead); the port follows the kernel."""
    rng = np.random.default_rng(5)
    q, kp, vp, bt, _ = _paged(rng, 3, 8, 2, 64, 16, 16, sentinel_tail=False)
    lens = np.asarray([0, 5, 0], np.int32)
    want = jda.decode_attention_paged(*(jnp.asarray(a) for a in (q, kp, vp, bt, lens)),
                                      interpret=True)
    got = tda.decode_attention_paged_plain(*(torch.from_numpy(a) for a in
                                             (q, kp, vp, bt, lens)))
    assert (got[0] == 0).all() and (got[2] == 0).all()
    assert np.abs(np.asarray(want)[[0, 2]]).max() == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# -- prefill -------------------------------------------------------------------


def _prefill_inputs(rng, B, T, H, KV, D, page, num_pages):
    return (_normal(rng, (B, T, H, D)), _normal(rng, (B, T, KV, D)),
            _normal(rng, (B, T, KV, D)), _normal(rng, (num_pages, page, KV, D)),
            _normal(rng, (num_pages, page, KV, D)))


def _run_prefill_both(q, kn, vn, kp, vp, bt, base, clens):
    jo, jk, jv = jpa.prefill_attention_paged(
        *(jnp.asarray(a) for a in (q, kn, vn, kp, vp, bt, base, clens)),
        block_q=8, interpret=True)
    to, tk, tv = tpa.prefill_attention_paged_plain(
        *(torch.from_numpy(np.array(a)) for a in (q, kn, vn, kp, vp, bt, base, clens)))
    return (np.asarray(jo), np.asarray(jk), np.asarray(jv)), (to.numpy(), tk.numpy(), tv.numpy())


@pytest.mark.parametrize("H,KV", [(4, 4), (8, 2), (4, 1), (32, 4)])
def test_prefill_plain_matches_pallas(H, KV):
    B, T, D, page, num_pages = 3, 8, 32, 16, 16
    rng = np.random.default_rng(H * 10 + KV)
    q, kn, vn, kp, vp = _prefill_inputs(rng, B, T, H, KV, D, page, num_pages)
    # scrambled physical pages + sentinel (unallocated) tail entries
    bt = np.array([[5, 9, 2, num_pages], [0, 7, num_pages, num_pages + 3],
                   [11, 3, 8, 1]], np.int32)
    base = np.array([0, 5, 13], np.int32)
    clens = np.array([8, 3, 0], np.int32)  # full / partial / inert row
    (jo, jk, jv), (to, tk, tv) = _run_prefill_both(q, kn, vn, kp, vp, bt, base, clens)
    np.testing.assert_allclose(to, jo, **TOL)
    np.testing.assert_array_equal(tk, jk)  # cache writes: exact
    np.testing.assert_array_equal(tv, jv)
    assert (to[1, 3:] == 0).all() and (to[2] == 0).all()  # padding rows


@pytest.mark.parametrize("base,clens", [
    ([14, 30, 0], [8, 8, 8]),    # straddle page edges at 16 and 32
    ([16, 47, 9], [5, 1, 0]),    # start on an edge, one token, inert
    ([40, 0, 24], [8, 2, 7]),    # chunk ends on the last page
])
def test_prefill_plain_page_straddles(base, clens):
    B, T, H, KV, D, page, max_pages = 3, 8, 8, 2, 16, 16, 3
    num_pages = B * max_pages + 2
    rng = np.random.default_rng(sum(base))
    q, kn, vn, kp, vp = _prefill_inputs(rng, B, T, H, KV, D, page, num_pages)
    bt = rng.permutation(num_pages)[:B * max_pages].reshape(B, max_pages).astype(np.int32)
    (jo, jk, jv), (to, tk, tv) = _run_prefill_both(
        q, kn, vn, kp, vp, bt, np.asarray(base, np.int32), np.asarray(clens, np.int32))
    np.testing.assert_allclose(to, jo, **TOL)
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_array_equal(tv, jv)


def test_prefill_plain_matches_contiguous_oracle():
    """An identity-mapped pool is a contiguous cache: the plain paged
    prefill equals the JAX contiguous-layout oracle."""
    B, T, H, KV, D, page, max_pages = 2, 8, 4, 2, 32, 16, 3
    S = page * max_pages
    rng = np.random.default_rng(21)
    q, kn, vn = _normal(rng, (B, T, H, D)), _normal(rng, (B, T, KV, D)), _normal(rng, (B, T, KV, D))
    kc, vc = _normal(rng, (B, S, KV, D)), _normal(rng, (B, S, KV, D))
    base, clens = np.array([0, 17], np.int32), np.array([8, 6], np.int32)
    want, wk, _ = jref.prefill_attention_ref(
        *(jnp.asarray(a) for a in (q, kn, vn, kc, vc, base, clens)))
    bt = np.arange(B * max_pages, dtype=np.int32).reshape(B, max_pages)
    got, gk, _ = tpa.prefill_attention_paged_plain(
        *(torch.from_numpy(np.array(a)) for a in
          (q, kn, vn, kc.reshape(B * max_pages, page, KV, D),
           vc.reshape(B * max_pages, page, KV, D), bt, base, clens)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(gk.numpy().reshape(B, S, KV, D), np.asarray(wk))


# -- cache scatters -----------------------------------------------------------


@pytest.mark.parametrize("case", sorted(sc.SCATTER_CASES))
def test_write_chunk_paged_exact(case):
    """The plain scatter equals JAX's bitwise on the edge cases the
    scatter kernel must reproduce (tests/paged_scatter_cases.py)."""
    rng = np.random.default_rng(3)
    num_pages, (base, clens, bt) = sc.SCATTER_CASES[case]
    B, T, KV, D, page = sc.B, sc.T, 2, 16, sc.PAGE
    pages = _normal(rng, (num_pages, page, KV, D))
    new = _normal(rng, (B, T, KV, D))
    bt, base, clens = (np.array(a, np.int32) for a in (bt, base, clens))
    want = jpa.write_chunk_paged(*(jnp.asarray(a) for a in (pages, bt, new, base, clens)))
    got = tpa.write_chunk_paged(*(torch.from_numpy(np.array(a)) for a in
                                  (pages, bt, new, base, clens)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_paged_append_exact():
    rng = np.random.default_rng(4)
    B, KV, D, page, num_pages, max_pages = 5, 2, 16, 4, 8, 3
    pages = _normal(rng, (num_pages, page, KV, D))
    vals = _normal(rng, (B, KV, D))
    bt = np.array([[3, 7, 1], [0, num_pages, num_pages], [5, 2, 6],
                   [num_pages] * 3, [4, 6, 1]], np.int32)
    idx = np.array([5, 4, 11, 0, 12], np.int32)  # sentinel row, past max_pages
    want = jblocks._paged_append(*(jnp.asarray(a) for a in (pages, bt, idx, vals)))
    got = tpa.paged_append_plain(*(torch.from_numpy(np.array(a)) for a in
                                   (pages, bt, idx, vals)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- dispatch ------------------------------------------------------------------


def _small_decode():
    rng = np.random.default_rng(0)
    return [torch.from_numpy(a) for a in _paged(rng, 2, 4, 2, 64, 16, 16)]


def _small_prefill():
    rng = np.random.default_rng(1)
    q, kn, vn, kp, vp = _prefill_inputs(rng, 2, 4, 4, 2, 16, 16, 6)
    bt = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
    return [torch.from_numpy(np.array(a)) for a in
            (q, kn, vn, kp, vp, bt, np.array([0, 9], np.int32),
             np.array([4, 2], np.int32))]


def test_ops_auto_on_cpu_takes_plain_and_launches_nothing():
    dec0 = tda.decode_attention_paged_kernel.launches
    pf0 = tpa.prefill_attention_paged_kernel.launches
    args = _small_decode()
    np.testing.assert_array_equal(
        ops.decode_attention_paged(*args, impl="auto").numpy(),
        ops.decode_attention_paged(*args, impl="ref").numpy())
    pa = _small_prefill()
    pb = [a.clone() for a in pa]
    got = ops.prefill_attention_paged(*pa, impl="auto")
    want = ops.prefill_attention_paged(*pb, impl="ref")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert tda.decode_attention_paged_kernel.launches == dec0 == 0
    assert tpa.prefill_attention_paged_kernel.launches == pf0 == 0


def _small_append():
    """Pools, a table with a sentinel, append positions (one past
    max_pages' reach from the end: -1) and one new K/V row per row."""
    rng = np.random.default_rng(5)
    B, KV, D, page, num_pages = 3, 2, 16, 4, 8
    bt = np.array([[3, 7, 1], [0, num_pages, 2], [5, 4, 6]], np.int32)
    return [torch.from_numpy(np.array(a)) for a in
            (_normal(rng, (num_pages, page, KV, D)), _normal(rng, (num_pages, page, KV, D)),
             bt, np.array([5, 4, -1], np.int32), _normal(rng, (B, KV, D)),
             _normal(rng, (B, KV, D)))]


@pytest.mark.parametrize("impl", ["auto", "ref"])
def test_ops_paged_append_on_cpu_is_the_plain_append(impl):
    """The decode step's cache write through ops: on CPU tensors both
    impls are the plain append (held against JAX above) on each pool, and
    the scatter kernel never launches."""
    a = _small_append()
    kp, vp, bt, idx, kr, vr = (t.clone() for t in a)
    n0 = tpa.write_chunk_paged_kernel.launches
    gk, gv = ops.paged_append(*a, impl=impl)
    np.testing.assert_array_equal(gk.numpy(), tpa.paged_append_plain(kp, bt, idx, kr).numpy())
    np.testing.assert_array_equal(gv.numpy(), tpa.paged_append_plain(vp, bt, idx, vr).numpy())
    assert tpa.write_chunk_paged_kernel.launches == n0 == 0


@pytest.mark.parametrize("op", ["decode", "prefill", "append"])
def test_ops_cuda_mode_on_cpu_raises(op):
    if op == "decode":
        with pytest.raises(ValueError, match="CUDA"):
            ops.decode_attention_paged(*_small_decode(), impl="cuda")
    elif op == "prefill":
        with pytest.raises(ValueError, match="CUDA"):
            ops.prefill_attention_paged(*_small_prefill(), impl="cuda")
    else:
        with pytest.raises(ValueError, match="CUDA"):
            ops.paged_append(*_small_append(), impl="cuda")


def test_ops_rejects_unknown_impl():
    with pytest.raises(ValueError, match="impl"):
        ops.decode_attention_paged(*_small_decode(), impl="pallas")
