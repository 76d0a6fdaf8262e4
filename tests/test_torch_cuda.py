"""The CUDA kernels of ``repro_torch`` (paged and contiguous serving with
the paged cache scatter, flash attention, rmsnorm, the dataframe's
hash-partition histogram) against their plain PyTorch versions, on the
card.  Every test here needs an
NVIDIA GPU with nvcc and skips elsewhere; on the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no jax, so it runs where only torch is installed."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
import paged_scatter_cases as sc  # noqa: E402

from repro_torch.dataframe import ops_dist as tdd  # noqa: E402
from repro_torch.dataframe.table import Table as TTable  # noqa: E402
from repro_torch.kernels import decode_attention as tda  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import hash_partition as thp  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import prefill_attention as tpa  # noqa: E402
from repro_torch.kernels import rmsnorm as trn  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402

# fp32 sums in another order; bf16 outputs may round one bf16 ulp apart
TOLS = [("float32", 1e-4), ("bfloat16", 2e-2)]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (run on the card)")


def _randn(rng, shape, dtype):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).cuda().to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", TOLS)
def test_decode_kernel_matches_plain(dtype, tol):
    """Full tinyllama widths; an empty row, page edges and sentinels."""
    _card()
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(7)
    B, H, KV, D, page, mp = 5, 32, 4, 64, 16, 16
    num_pages = B * mp + 2
    lens = np.array([0, 1, 16, 17, 256], np.int32)
    bt = rng.permutation(num_pages)[:B * mp].reshape(B, mp).astype(np.int32)
    for b, n in enumerate(lens):
        bt[b, -(-n // page):] = num_pages + b  # sentinels past each length
    args = (_randn(rng, (B, H, D), dt), _randn(rng, (num_pages, page, KV, D), dt),
            _randn(rng, (num_pages, page, KV, D), dt), torch.from_numpy(bt).cuda(),
            torch.from_numpy(lens).cuda())
    got = tda.decode_attention_paged_kernel(*args)
    want = tda.decode_attention_paged_plain(*args)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= tol
    assert (got[0] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", TOLS)
def test_prefill_kernel_matches_plain(dtype, tol):
    """Full tinyllama widths: a full chunk, a straddling partial chunk, an
    inert row; the pools are written identically, padding rows are zero."""
    _card()
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(8)
    B, T, H, KV, D, page, mp = 3, 64, 32, 4, 64, 16, 8
    num_pages = B * mp + 1
    bt = rng.permutation(num_pages)[:B * mp].reshape(B, mp).astype(np.int32)
    bt[1, 4:] = num_pages + 1  # sentinels past row 1's frontier (57 tokens)
    q, kn, vn = (_randn(rng, s, dt) for s in ((B, T, H, D), (B, T, KV, D), (B, T, KV, D)))
    kp, vp = (_randn(rng, (num_pages, page, KV, D), dt) for _ in range(2))
    rest = [torch.from_numpy(a).cuda() for a in
            (bt, np.array([0, 37, 100], np.int32), np.array([64, 20, 0], np.int32))]
    go, gk, gv = tpa.prefill_attention_paged_kernel(q, kn, vn, kp.clone(), vp.clone(), *rest)
    wo, wk, wv = tpa.prefill_attention_paged_plain(q, kn, vn, kp.clone(), vp.clone(), *rest)
    torch.cuda.synchronize()
    assert (go.float() - wo.float()).abs().max().item() <= tol
    assert torch.equal(gk, wk) and torch.equal(gv, wv)
    assert (go[1, 20:] == 0).all() and (go[2] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", TOLS)
def test_contiguous_decode_kernel_matches_plain(dtype, tol):
    """Full tinyllama widths at the serving max_len: an empty row, one
    token, S-1, S and a length past S; a scalar length; a window; an S
    that is not a power of two."""
    _card()
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(9)
    H, KV, D = 32, 4, 64
    for S, lens, window in ((512, [0, 1, 37, 511, 512, 600], 0),
                            (512, 300, 0),
                            (512, [5, 64, 300, 512], 40),
                            (200, [0, 1, 199, 200], 0)):
        B = len(lens) if isinstance(lens, list) else 3
        args = (_randn(rng, (B, H, D), dt), _randn(rng, (B, S, KV, D), dt),
                _randn(rng, (B, S, KV, D), dt),
                torch.tensor(lens, dtype=torch.int32).cuda())
        got = tda.decode_attention_kernel(*args, window=window)
        want = tda.decode_attention_plain(*args, window=window)
        torch.cuda.synchronize()
        assert (got.float() - want.float()).abs().max().item() <= tol
        if isinstance(lens, list) and lens[0] == 0:
            assert (got[0] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", TOLS)
def test_contiguous_prefill_kernel_matches_plain(dtype, tol):
    """Full tinyllama widths: a full chunk, a partial chunk, an inert row
    and a chunk that reaches the end of the row with T past it (those
    tokens drop); the caches are written identically, padding rows are
    zero."""
    _card()
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(10)
    B, T, H, KV, D, S = 4, 64, 32, 4, 64, 256
    q, kn, vn = (_randn(rng, s, dt) for s in ((B, T, H, D), (B, T, KV, D), (B, T, KV, D)))
    kc, vc = (_randn(rng, (B, S, KV, D), dt) for _ in range(2))
    base = torch.tensor([0, 37, 100, 216], dtype=torch.int32).cuda()
    clens = torch.tensor([64, 20, 0, 64], dtype=torch.int32).cuda()
    go, gk, gv = tpa.prefill_attention_kernel(q, kn, vn, kc.clone(), vc.clone(), base, clens)
    wo, wk, wv = tpa.prefill_attention_plain(q, kn, vn, kc.clone(), vc.clone(), base, clens)
    torch.cuda.synchronize()
    assert (go.float() - wo.float()).abs().max().item() <= tol
    assert torch.equal(gk, wk) and torch.equal(gv, wv)
    assert (go[1, 20:] == 0).all() and (go[2] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype,tol", TOLS)
def test_flash_kernel_matches_plain(dtype, tol, causal):
    """The training shape (B 8, H 32, KV 4, S 512, D 64), an S that is not
    a multiple of the tile, S = 1, D 16 and D 128, MHA (G = 1); and the
    model's [B, S, H, D] activations viewed as [B, H, S, D]."""
    _card()
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(11)
    for B, H, KV, S, D in ((8, 32, 4, 512, 64), (2, 8, 2, 200, 64),
                           (3, 4, 1, 1, 32), (1, 4, 2, 77, 16),
                           (1, 8, 8, 130, 128)):
        q, k, v = (_randn(rng, s, dt) for s in ((B, H, S, D), (B, KV, S, D), (B, KV, S, D)))
        got = tfa.flash_attention_kernel(q, k, v, causal=causal)
        want = tfa.flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert got.shape == q.shape and got.dtype == dt
        assert (got.float() - want.float()).abs().max().item() <= tol, (B, H, KV, S, D)
        views = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v)]
        got_v = tfa.flash_attention_kernel(*views, causal=causal)
        assert got_v.stride() == views[0].stride()
        assert torch.equal(got_v, got)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype,tol", TOLS)
def test_flash_kernel_sweep(dtype, tol, causal, D):
    """Every S around the 64-row tile (1, 63, 64, 65, 127), the training S
    and a long ragged one, G 1 and 8, on the model's [B, S, H, D]
    activations viewed as [B, H, S, D]: the bf16 tensor-core kernel and the
    fp32 CUDA-core one against the plain version."""
    _card()
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(20 + D)
    for S in (1, 63, 64, 65, 127, 512, 1000):
        for G in (1, 8):
            B, KV = 2, 2
            q, k, v = (_randn(rng, (B, S, n, D), dt).transpose(1, 2)
                       for n in (KV * G, KV, KV))
            got = tfa.flash_attention_kernel(q, k, v, causal=causal)
            want = tfa.flash_attention_plain(q, k, v, causal=causal)
            torch.cuda.synchronize()
            assert got.shape == q.shape and got.stride() == q.stride()
            err = (got.float() - want.float()).abs().max().item()
            assert err <= tol, (S, G, err)


def _paged_case(rng, dt, B, T, H, KV, D, page, max_pages, base, clens):
    """Pools with spare pages, a scrambled table giving each row the pages
    its prefix needs, sentinels (some far past num_pages) elsewhere."""
    need = [min(-(-(b + c) // page), max_pages) for b, c in zip(base, clens)]
    num_pages = sum(need) + 2
    ids = rng.permutation(num_pages)
    bt = np.full((B, max_pages), num_pages, np.int32)
    for b, n in enumerate(need):
        bt[b, :n], ids = ids[:n], ids[n:]
        bt[b, n:] += 1000 * b
    q, kn, vn = (_randn(rng, s, dt) for s in ((B, T, H, D), (B, T, KV, D), (B, T, KV, D)))
    kp, vp = (_randn(rng, (num_pages, page, KV, D), dt) for _ in range(2))
    rest = [torch.from_numpy(np.asarray(a, np.int32)).cuda() for a in (bt, base, clens)]
    return [q, kn, vn, kp, vp] + rest


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 15, 16, 17, 64])
@pytest.mark.parametrize("dtype,tol", TOLS)
def test_paged_prefill_kernel_sweep(dtype, tol, T):
    """Full tinyllama widths (G 8, D 64): bases 0, 5, 16 and 447 with
    full, partial and empty chunks, a row whose chunk runs past max_pages
    (its tail drops and it attends the table's whole capacity), sentinels
    in every table; pools bitwise, padding rows exactly zero."""
    _card()
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(30 + T)
    page, max_pages, H, KV, D = 16, 32, 32, 4, 64
    base = [0, 5, 16, 447, 500, 3]
    clens = [T, max(T - 3, 0), T, T, T, 0]
    args = _paged_case(rng, dt, len(base), T, H, KV, D, page, max_pages, base, clens)
    q, kn, vn, kp, vp, bt, bs, cl = args
    go, gk, gv = tpa.prefill_attention_paged_kernel(q, kn, vn, kp.clone(), vp.clone(), bt, bs, cl)
    wo, wk, wv = tpa.prefill_attention_paged_plain(q, kn, vn, kp.clone(), vp.clone(), bt, bs, cl)
    torch.cuda.synchronize()
    assert torch.equal(gk, wk) and torch.equal(gv, wv)
    pad = torch.arange(T, device="cuda")[None, :] >= cl[:, None]
    assert bool((go[pad] == 0).all())
    assert (go.float() - wo.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("G,D", [(1, 16), (4, 32), (8, 128), (128, 64)])
def test_paged_prefill_kernel_other_widths(G, D):
    """bf16 at other GQA groups and head dims: G 128 (two tiles a token),
    D 16, 32 and 128."""
    _card()
    rng = np.random.default_rng(40 + D)
    base, clens = [0, 21, 60], [17, 9, 0]
    args = _paged_case(rng, torch.bfloat16, 3, 17, 2 * G, 2, D, 16, 8, base, clens)
    q, kn, vn, kp, vp, bt, bs, cl = args
    go, gk, gv = tpa.prefill_attention_paged_kernel(q, kn, vn, kp.clone(), vp.clone(), bt, bs, cl)
    wo, wk, wv = tpa.prefill_attention_paged_plain(q, kn, vn, kp.clone(), vp.clone(), bt, bs, cl)
    torch.cuda.synchronize()
    assert torch.equal(gk, wk) and torch.equal(gv, wv)
    assert (go.float() - wo.float()).abs().max().item() <= 2e-2
    assert (go[1, 9:] == 0).all() and (go[2] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(sc.SCATTER_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_scatter_kernel_bitwise(case, dtype):
    """The scatter entry point writes the pools exactly where the plain
    write_chunk_paged does, on its edge cases."""
    _card()
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(50)
    num_pages, (base, clens, bt) = sc.SCATTER_CASES[case]
    B, T, KV, D, page = sc.B, sc.T, 2, 16, sc.PAGE
    kp, vp = (_randn(rng, (num_pages, page, KV, D), dt) for _ in range(2))
    kn, vn = (_randn(rng, (B, T, KV, D), dt) for _ in range(2))
    bt, bs, cl = (torch.tensor(a, dtype=torch.int32).cuda() for a in (bt, base, clens))
    gk, gv = tpa.write_chunk_paged_kernel(kp.clone(), vp.clone(), bt, kn, vn, bs, cl)
    wk = tpa.write_chunk_paged(kp.clone(), bt, kn, bs, cl)
    wv = tpa.write_chunk_paged(vp.clone(), bt, vn, bs, cl)
    torch.cuda.synchronize()
    assert torch.equal(gk, wk) and torch.equal(gv, wv)


@pytest.mark.cuda
def test_paged_paths_make_no_host_sync():
    """The paged prefill wrapper (scatter + attention) and the decode
    append on the kernel run under sync-debug "error": a host sync would
    raise.  The append equals the plain one bitwise."""
    _card()
    rng = np.random.default_rng(60)
    q, kn, vn, kp, vp, bt, bs, cl = _paged_case(
        rng, torch.bfloat16, 4, 64, 32, 4, 64, 16, 8, [64, 0, 0, 0], [64, 0, 5, 0])
    idx = torch.tensor([5, 17, -1, 127], dtype=torch.int32).cuda()
    kr, vr = (_randn(rng, (4, 4, 64), torch.bfloat16) for _ in range(2))
    wk, wv = tops.paged_append(kp.clone(), vp.clone(), bt, idx, kr, vr, impl="ref")
    gk, gv = kp.clone(), vp.clone()
    torch.cuda.synchronize()
    launches = tpa.write_chunk_paged_kernel.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        tpa.prefill_attention_paged_kernel(q, kn, vn, kp, vp, bt, bs, cl)
        tops.paged_append(gk, gv, bt, idx, kr, vr)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert tpa.write_chunk_paged_kernel.launches == launches + 2
    assert torch.equal(gk, wk) and torch.equal(gv, wv)


@pytest.mark.cuda
def test_flash_function_gradients_match_plain():
    """fp32: the kernel's Function (backward through chunked_attention)
    against autograd of the plain version; gradients sum in another
    order, so 1e-4."""
    _card()
    rng = np.random.default_rng(12)
    B, H, KV, S, D = 2, 8, 2, 96, 64
    leaves = [_randn(rng, s, torch.float32).requires_grad_()
              for s in ((B, H, S, D), (B, KV, S, D), (B, KV, S, D))]
    ct = _randn(rng, (B, H, S, D), torch.float32)
    out = tfa.flash_attention_autograd(*leaves, q_chunk=32, kv_chunk=32)
    got = torch.autograd.grad(out, leaves, ct)
    want = torch.autograd.grad(tfa.flash_attention_plain(*leaves), leaves, ct)
    for g, w in zip(got, want):
        assert (g - w).abs().max().item() <= 1e-4


def _keys(rng, shape):
    """int32 keys over the whole range, the extremes first."""
    keys = rng.integers(-2 ** 31, 2 ** 31, shape, dtype=np.int64).astype(np.int32)
    flat = keys.reshape(-1)
    ext = np.array([-1, 0, 1, 2 ** 31 - 1, -2 ** 31], np.int32)[:flat.size]
    flat[:len(ext)] = ext
    return torch.from_numpy(keys).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2047, 2048, 2049, 100_003, 1 << 23])
def test_hash_kernel_matches_plain_bitwise(n):
    """Counts are integers: the kernel equals its plain version exactly,
    for every bucket count, block size, a batch of rows and keys that do
    not start on a 16-byte boundary."""
    _card()
    rng = np.random.default_rng(13)
    keys = _keys(rng, (n + 3,))
    for P in (4, 8, 16, 64, 4096):
        for block, k in ((2048, keys[:n]), (512, keys[3:])):
            got = thp.hash_partition_histogram_kernel(k, num_buckets=P, block=block)
            want = thp.hash_partition_histogram_plain(k, num_buckets=P, block=block)
            torch.cuda.synchronize()
            assert got.dtype == torch.int32 and torch.equal(got, want), (P, block)
            assert int(got.sum()) == k.numel()
    rows = _keys(rng, (3, min(n, 5000)))
    assert torch.equal(thp.hash_partition_histogram_kernel(rows, num_buckets=8),
                       thp.hash_partition_histogram_plain(rows, num_buckets=8))


@pytest.mark.cuda
def test_hash_kernel_refuses_what_it_does_not_take():
    _card()
    keys = torch.arange(64, dtype=torch.int32, device="cuda")
    for bad, kw in ((keys.long(), {}), (keys.view(4, 4, 4), {}),
                    (keys.view(8, 8).t(), {}), (keys.cpu(), {}),
                    (keys, {"num_buckets": thp.MAX_BUCKETS + 1}),
                    (keys, {"num_buckets": 0}), (keys[:0], {})):
        with pytest.raises(ValueError):
            thp.hash_partition_histogram_kernel(bad, **{"num_buckets": 4, **kw})


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_rmsnorm_kernel_matches_plain(dtype, tol):
    """Training activations [4096, 2048], the shapes of tests/test_kernels.py,
    d 5120 (block per row), d 1001 (no 16-byte access) and w in fp32; atol
    = rtol as tests/test_kernels.py (a bf16 ulp grows with the value)."""
    _card()
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(14)
    for shape in ((4096, 2048), (4, 17, 256), (1, 5120), (32, 128), (1, 512),
                  (9, 1001), (3, 3072), (5, 1)):
        x = _randn(rng, shape, dt)
        for w in (_randn(rng, shape[-1:], dt), _randn(rng, shape[-1:], torch.float32)):
            got = trn.rmsnorm_kernel(x, w)
            want = trn.rmsnorm_plain(x, w)
            torch.cuda.synchronize()
            assert got.shape == x.shape and got.dtype == dt
            torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_rmsnorm_kernel_refuses_what_it_does_not_take():
    _card()
    x = torch.randn(4, 8, device="cuda")
    w = torch.randn(8, device="cuda")
    for bad_x, bad_w in ((x.half(), w), (x, w.half()), (x.t(), w[:4]),
                         (x, w[:4]), (x.cpu(), w), (x, w.cpu())):
        with pytest.raises(ValueError):
            trn.rmsnorm_kernel(bad_x, bad_w)


@pytest.mark.cuda
def test_dataframe_path_counts_its_hash_launches():
    """shuffle, join and groupby on the card launch the histogram kernel
    once per exchange (1, 2, 1), sort and reduce never, and equal the
    impl="ref" run: every column bitwise but the groupby's sums (the
    moved floats too)."""
    _card()
    rng = np.random.default_rng(15)
    n = 1 << 16
    mesh = make_mesh((8,), ("data",))
    t = TTable.from_columns({"k": rng.integers(0, 1 << 12, n).astype(np.int32),
                             "v": rng.normal(size=n).astype(np.float32)}, mesh,
                            valid=rng.random(n) < 0.9)
    r = TTable.from_columns({"k": np.arange(1 << 12, dtype=np.int32),
                             "w": np.arange(1 << 12, dtype=np.float32)}, mesh)
    for fn, launches, sums in (
            (lambda impl: tdd.shuffle(t, "k", impl=impl), 1, ()),
            (lambda impl: tdd.join(t, r, "k", impl=impl), 2, ()),
            (lambda impl: tdd.groupby_sum(t, "k", ["v"], impl=impl), 1, ("v",))):
        thp.hash_partition_histogram_kernel.launches = 0
        got, gd = fn("auto")
        assert thp.hash_partition_histogram_kernel.launches == launches
        want, wd = fn("ref")
        assert thp.hash_partition_histogram_kernel.launches == launches
        assert gd == wd == 0 and torch.equal(got.valid, want.valid)
        for col in got.columns:
            if col in sums:  # index_add_ adds with atomics on the card
                torch.testing.assert_close(got.col(col), want.col(col))
            else:
                assert torch.equal(got.col(col), want.col(col)), col
    thp.hash_partition_histogram_kernel.launches = 0
    tdd.sort(t, "k")
    tdd.reduce_sum(t, ["v"])
    assert thp.hash_partition_histogram_kernel.launches == 0


@pytest.mark.cuda
def test_rmsnorm_ops_entry_point_launches_the_kernel():
    _card()
    x = torch.randn(16, 256, device="cuda", dtype=torch.bfloat16)
    w = torch.randn(256, device="cuda", dtype=torch.bfloat16)
    trn.rmsnorm_kernel.launches = 0
    tops.rmsnorm(x, w)
    tops.rmsnorm(x, w, impl="ref")
    assert trn.rmsnorm_kernel.launches == 1
