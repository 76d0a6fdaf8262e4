"""Port parity: the plain versions of the contiguous-cache kernels
(``repro_torch`` ``decode_attention`` and ``prefill_attention``) against
the JAX Pallas kernels in interpret mode and the jnp oracles, on the
sweeps of tests/test_kernels.py and tests/test_prefill_kernel.py; the
cache writes exactly; the ops dispatch; and the kernel build's source
hashing.  The CUDA kernels themselves run only on the card
(tests/test_torch_cuda.py)."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import decode_attention as jda  # noqa: E402
from repro.kernels import prefill_attention as jpa  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import decode_attention as tda  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import prefill_attention as tpa  # noqa: E402
from repro_torch.models import blocks as tblocks  # noqa: E402

TOL = dict(atol=2e-5, rtol=2e-5)  # fp32, as tests/test_kernels.py


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _decode_inputs(rng, B, H, KV, S, D):
    return (_normal(rng, (B, H, D)), _normal(rng, (B, S, KV, D)),
            _normal(rng, (B, S, KV, D)))


def _decode_both(q, k, v, lens, window=0, **kw):
    want = jda.decode_attention(*(jnp.asarray(a) for a in (q, k, v, lens)),
                                window=window, interpret=True, **kw)
    got = tda.decode_attention_plain(*(torch.from_numpy(np.asarray(a)) for a in
                                       (q, k, v, lens)), window=window)
    return got.numpy(), np.asarray(want)


# -- decode --------------------------------------------------------------------


@pytest.mark.parametrize("B,H,KV,S,D,bk", [
    (2, 8, 2, 512, 64, 128),    # GQA 4x
    (1, 4, 4, 256, 128, 64),    # MHA
    (4, 16, 1, 1024, 64, 256),  # MQA
    (2, 4, 4, 128, 48, 64),     # MLA-expanded layout (KV == H, qk dim 48)
    (3, 32, 4, 512, 64, 512),   # tinyllama width at the serving max_len
    (3, 8, 2, 200, 16, 512),    # S not a multiple of block_k: one block
    (2, 8, 2, 768, 32, 512),    # S > block_k, not a multiple: one block
])
@pytest.mark.parametrize("scalar", [True, False])
def test_decode_plain_matches_pallas(B, H, KV, S, D, bk, scalar):
    rng = np.random.default_rng(B * 100 + D + S)
    q, k, v = _decode_inputs(rng, B, H, KV, S, D)
    lens = (np.asarray(S * 3 // 4, np.int32) if scalar
            else rng.integers(1, S + 1, B).astype(np.int32))
    got, want = _decode_both(q, k, v, lens, block_k=bk)
    np.testing.assert_allclose(got, want, **TOL)
    # and the jnp oracle (which agrees wherever a row has a live position)
    oracle = jref.decode_attention_ref(*(jnp.asarray(a) for a in (q, k, v, lens)))
    np.testing.assert_allclose(got, np.asarray(oracle), **TOL)


@pytest.mark.parametrize("window", [8, 64, 100])
def test_decode_plain_windowed_matches_pallas(window):
    B, H, KV, S, D = 4, 8, 2, 256, 32
    rng = np.random.default_rng(window)
    q, k, v = _decode_inputs(rng, B, H, KV, S, D)
    lens = np.asarray([S, S // 2, window + 1, 3], np.int32)
    got, want = _decode_both(q, k, v, lens, window=window, block_k=64)
    np.testing.assert_allclose(got, want, **TOL)
    oracle = jref.decode_attention_ref(*(jnp.asarray(a) for a in (q, k, v, lens)),
                                       window=window)
    np.testing.assert_allclose(got, np.asarray(oracle), **TOL)


def test_decode_plain_empty_rows_and_lengths_past_the_cache():
    """cache_len 0 gives zeros, as the Pallas kernel does (the jnp oracle
    returns the mean of V); a length past S attends the whole row."""
    B, H, KV, S, D = 4, 8, 2, 64, 16
    rng = np.random.default_rng(5)
    q, k, v = _decode_inputs(rng, B, H, KV, S, D)
    lens = np.asarray([0, 1, S, S + 9], np.int32)
    got, want = _decode_both(q, k, v, lens, block_k=32)
    assert (got[0] == 0).all() and np.abs(want[0]).max() == 0.0
    np.testing.assert_allclose(got, want, **TOL)
    solo = tda.decode_attention_plain(*(torch.from_numpy(a[3:]) for a in (q, k, v)),
                                      torch.tensor([S], dtype=torch.int32))
    np.testing.assert_allclose(got[3], solo.numpy()[0], **TOL)


def test_decode_plain_ignores_positions_past_the_length():
    B, H, KV, S, D = 2, 4, 2, 128, 32
    rng = np.random.default_rng(6)
    q, k, v = _decode_inputs(rng, B, H, KV, S, D)
    lens = torch.tensor([37, 100], dtype=torch.int32)
    base = tda.decode_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)), lens)
    k2, v2 = k.copy(), v.copy()
    k2[0, 37:], v2[0, 37:], k2[1, 100:], v2[1, 100:] = 7.0, -7.0, 7.0, -7.0
    got = tda.decode_attention_plain(*(torch.from_numpy(a) for a in (q, k2, v2)), lens)
    np.testing.assert_allclose(got.numpy(), base.numpy(), **TOL)


def test_contiguous_split_span_covers_the_row_in_whole_tiles():
    for B, KV, S in ((8, 4, 512), (1, 1, 128), (3, 2, 200), (64, 8, 4096)):
        span = tda.contiguous_split_span(B, KV, S)
        assert span % 32 == 0 and span >= 32
        nsplit = -(-S // span)
        assert nsplit * span >= S > (nsplit - 1) * span
    # the serving shape: 8 slots x 4 KV heads spread over ~2 blocks per SM
    assert tda.contiguous_split_span(8, 4, 512) * 8 == 512


# -- prefill -------------------------------------------------------------------


def _prefill_inputs(rng, B, T, H, KV, D, S):
    return (_normal(rng, (B, T, H, D)), _normal(rng, (B, T, KV, D)),
            _normal(rng, (B, T, KV, D)), _normal(rng, (B, S, KV, D)),
            _normal(rng, (B, S, KV, D)))


def _prefill_both(q, kn, vn, kc, vc, base, clens, **kw):
    jo, jk, jv = jpa.prefill_attention(
        *(jnp.asarray(a) for a in (q, kn, vn, kc, vc, base, clens)),
        interpret=True, **kw)
    to, tk, tv = tpa.prefill_attention_plain(
        *(torch.from_numpy(np.array(a)) for a in (q, kn, vn, kc, vc, base, clens)))
    return (np.asarray(jo), np.asarray(jk), np.asarray(jv)), (to.numpy(), tk.numpy(), tv.numpy())


@pytest.mark.parametrize("H,KV", [(4, 4), (8, 2), (4, 1), (32, 4)])  # MHA/GQA/MQA
def test_prefill_plain_matches_pallas(H, KV):
    B, T, D, S = 3, 8, 32, 64
    rng = np.random.default_rng(H * 10 + KV)
    q, kn, vn, kc, vc = _prefill_inputs(rng, B, T, H, KV, D, S)
    base = np.array([0, 5, 13], np.int32)
    clens = np.array([8, 3, 0], np.int32)  # full / partial / inert row
    (jo, jk, jv), (to, tk, tv) = _prefill_both(q, kn, vn, kc, vc, base, clens,
                                               block_q=8, block_k=16)
    np.testing.assert_allclose(to, jo, **TOL)
    np.testing.assert_array_equal(tk, jk)  # cache writes: exact
    np.testing.assert_array_equal(tv, jv)
    assert (to[1, 3:] == 0).all() and (to[2] == 0).all()  # padding rows
    np.testing.assert_array_equal(tk[2], kc[2])  # the inert row wrote nothing


@pytest.mark.parametrize("base,clens", [
    ([56, 60, 0], [8, 8, 8]),    # row 0 ends exactly at S; row 1 runs past it
    ([63, 64, 70], [8, 3, 1]),   # one live token at S-1; rows wholly past S
])
def test_prefill_plain_drops_positions_past_the_cache(base, clens):
    B, T, H, KV, D, S = 3, 8, 8, 2, 16, 64
    rng = np.random.default_rng(sum(base))
    q, kn, vn, kc, vc = _prefill_inputs(rng, B, T, H, KV, D, S)
    (jo, jk, jv), (to, tk, tv) = _prefill_both(
        q, kn, vn, kc, vc, np.asarray(base, np.int32), np.asarray(clens, np.int32),
        block_q=8, block_k=16)
    np.testing.assert_allclose(to, jo, **TOL)
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_array_equal(tv, jv)


def test_prefill_plain_chunked_equals_one_shot():
    """Two chunks at offsets 0 and T1 write the same cache as one pass and
    give the same outputs."""
    B, T, H, KV, D, S, T1 = 2, 8, 4, 2, 32, 64, 3
    rng = np.random.default_rng(8)
    q, kn, vn, kc, vc = (torch.from_numpy(a) for a in _prefill_inputs(rng, B, T, H, KV, D, S))
    zero = torch.zeros(B, dtype=torch.int32)
    o_all, k_all, v_all = tpa.prefill_attention_plain(
        q, kn, vn, kc.clone(), vc.clone(), zero, torch.full((B,), T, dtype=torch.int32))
    k1, v1 = kc.clone(), vc.clone()
    o1, _, _ = tpa.prefill_attention_plain(q[:, :T1], kn[:, :T1], vn[:, :T1], k1, v1,
                                           zero, torch.full((B,), T1, dtype=torch.int32))
    o2, _, _ = tpa.prefill_attention_plain(
        q[:, T1:], kn[:, T1:], vn[:, T1:], k1, v1,
        torch.full((B,), T1, dtype=torch.int32), torch.full((B,), T - T1, dtype=torch.int32))
    assert torch.equal(k1, k_all) and torch.equal(v1, v_all)
    np.testing.assert_allclose(torch.cat([o1, o2], 1).numpy(), o_all.numpy(), **TOL)


def test_prefill_plain_matches_paged_plain_on_identity_table():
    """An identity-mapped pool is a contiguous cache: both plain versions
    agree bitwise."""
    B, T, H, KV, D, page, max_pages = 2, 8, 4, 2, 32, 16, 3
    S = page * max_pages
    rng = np.random.default_rng(21)
    q, kn, vn, kc, vc = (torch.from_numpy(a) for a in _prefill_inputs(rng, B, T, H, KV, D, S))
    base, clens = torch.tensor([0, 17], dtype=torch.int32), torch.tensor([8, 6], dtype=torch.int32)
    bt = torch.arange(B * max_pages, dtype=torch.int32).reshape(B, max_pages)
    co, ck, _ = tpa.prefill_attention_plain(q, kn, vn, kc.clone(), vc.clone(), base, clens)
    po, pk, _ = tpa.prefill_attention_paged_plain(
        q, kn, vn, kc.reshape(B * max_pages, page, KV, D).clone(),
        vc.reshape(B * max_pages, page, KV, D).clone(), bt, base, clens)
    assert torch.equal(co, po)
    assert torch.equal(ck, pk.reshape(B, S, KV, D))


# -- cache writes ----------------------------------------------------------------


def test_write_chunk_exact():
    rng = np.random.default_rng(3)
    B, T, S, KV, D = 5, 8, 16, 2, 8
    cache = _normal(rng, (B, S, KV, D))
    new = _normal(rng, (B, T, KV, D))
    base = np.array([0, 3, 10, 16, 12], np.int32)   # rows 2-4 reach S or start past it
    clens = np.array([8, 5, 6, 2, 0], np.int32)
    want = jpa.write_chunk(*(jnp.asarray(a) for a in (cache, new, base, clens)))
    got = tpa.write_chunk(*(torch.from_numpy(np.array(a)) for a in (cache, new, base, clens)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_slot_append_exact():
    """The per-slot decode append equals JAX's ``.at[rows, idx].set(...,
    mode="drop")``: a row at or past S writes nothing."""
    rng = np.random.default_rng(4)
    B, S, KV, D = 5, 6, 2, 8
    cache = _normal(rng, (B, S, KV, D))
    vals = _normal(rng, (B, KV, D))
    idx = np.array([0, 5, 6, 3, 11], np.int32)
    want = jnp.asarray(cache).at[jnp.arange(B), jnp.asarray(idx)].set(
        jnp.asarray(vals), mode="drop")
    got = tblocks._slot_append(torch.from_numpy(cache.copy()), torch.from_numpy(idx),
                               torch.from_numpy(vals))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # -1 (the engine's mark for a row that must not decode) drops too,
    # where JAX would wrap it to S-1
    got = tblocks._slot_append(torch.from_numpy(cache.copy()),
                               torch.tensor([-1, 2, -1, -1, -1], dtype=torch.int32),
                               torch.from_numpy(vals))
    want = cache.copy()
    want[1, 2] = vals[1]
    np.testing.assert_array_equal(got.numpy(), want)


# -- dispatch ------------------------------------------------------------------


def _small_decode():
    rng = np.random.default_rng(0)
    q, k, v = _decode_inputs(rng, 2, 4, 2, 64, 16)
    return [torch.from_numpy(a) for a in (q, k, v, np.array([5, 64], np.int32))]


def _small_prefill():
    rng = np.random.default_rng(1)
    return [torch.from_numpy(np.array(a)) for a in
            (*_prefill_inputs(rng, 2, 4, 4, 2, 16, 32), np.array([0, 9], np.int32),
             np.array([4, 2], np.int32))]


def test_ops_auto_on_cpu_takes_plain_and_launches_nothing():
    dec0 = tda.decode_attention_kernel.launches
    pf0 = tpa.prefill_attention_kernel.launches
    args = _small_decode()
    for window in (0, 3):
        np.testing.assert_array_equal(
            ops.decode_attention(*args, window=window, impl="auto").numpy(),
            ops.decode_attention(*args, window=window, impl="ref").numpy())
    pa = _small_prefill()
    pb = [a.clone() for a in pa]
    for g, w in zip(ops.prefill_attention(*pa, impl="auto"),
                    ops.prefill_attention(*pb, impl="ref")):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert tda.decode_attention_kernel.launches == dec0 == 0
    assert tpa.prefill_attention_kernel.launches == pf0 == 0


@pytest.mark.parametrize("op", ["decode", "prefill"])
def test_ops_cuda_mode_on_cpu_raises(op):
    with pytest.raises(ValueError, match="CUDA"):
        if op == "decode":
            ops.decode_attention(*_small_decode(), impl="cuda")
        else:
            ops.prefill_attention(*_small_prefill(), impl="cuda")


# -- build ----------------------------------------------------------------------


def test_build_knows_all_four_kernels():
    assert set(build.SIGNATURES) == {"decode_attention", "prefill_attention",
                                     "decode_attention_paged",
                                     "prefill_attention_paged",
                                     "flash_attention", "rmsnorm",
                                     "hash_partition"}
    for name in build.SIGNATURES:
        assert (build.CSRC / f"{name}.cu").exists()
        assert build.library_path(name).parent == build.BUILD_DIR


def test_library_path_hashes_the_shared_headers(tmp_path, monkeypatch):
    """An edited csrc/*.cuh header must name a new library, or a stale
    build would be loaded."""
    for f in build.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = {name: build.library_path(name) for name in build.SIGNATURES}
    header = tmp_path / "common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: build.library_path(name) for name in build.SIGNATURES}
    assert all(before[n] != after[n] for n in build.SIGNATURES)
