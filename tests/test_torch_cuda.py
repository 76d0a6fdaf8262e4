"""The CUDA kernels of ``repro_torch`` (paged and contiguous serving,
flash attention) against their plain PyTorch versions, on the card.  Every test here needs an
NVIDIA GPU with nvcc and skips elsewhere; on the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no jax, so it runs where only torch is installed."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels import decode_attention as tda  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import prefill_attention as tpa  # noqa: E402

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
