"""The CUDA kernels of ``repro_torch`` (paged and contiguous serving with
the paged cache scatter, flash attention, rmsnorm, the dataframe's
hash-partition histogram) against their plain PyTorch versions, on the
card, at every head dim the attention kernels take (16, 32, 64, 96,
128; the contiguous decode also 24), and at the shapes each served
config's path gives them (the fleet's whole-prompt prefill widths too);
the smoke MLA and MoE engines, the compacted paged chunk against the
full slab, the threefry sampler, a disaggregated
fleet, whisper's and qwen2-vl's paths, and kernels 5 and 3 launched by a
worker process of the subprocess transport, on the card.  Every test here needs an
NVIDIA GPU with nvcc and skips elsewhere; on the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no jax, so it runs where only torch is installed."""
import os

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
    """Full tinyllama widths; an empty row, page edges and sentinels;
    without a window and with windows of 1 and 100 positions."""
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
    for window in (0, 1, 100):
        got = tda.decode_attention_paged_kernel(*args, window=window)
        want = tda.decode_attention_paged_plain(*args, window=window)
        torch.cuda.synchronize()
        assert (got.float() - want.float()).abs().max().item() <= tol, window
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
@pytest.mark.parametrize("D", [16, 32, 64, 96, 128])
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
@pytest.mark.parametrize("G,D", [(1, 16), (4, 32), (8, 128), (128, 64), (1, 96), (8, 96)])
def test_paged_prefill_kernel_other_widths(G, D):
    """bf16 at other GQA groups and head dims: G 128 (two tiles a token),
    D 16, 32, 96 and 128."""
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


# the contiguous decode's sweep: lengths across the 16-key tile, the four
# warps' first round (64) and the row's end, an empty row, one past S
def _decode_lens(S):
    return [0, 1, 7, 8, 15, 16, 17, 63, 64, 65, S - 1, S, S + 5]


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 24, 32, 64, 96, 128])
@pytest.mark.parametrize("dtype,tol", TOLS)
def test_contiguous_decode_kernel_sweep(dtype, tol, D):
    """G 1, 4, 8, 16 and 32; S 32 (one block a row on both bodies: each
    writes out itself), 512 (one block a row on the tensor cores, split on
    the CUDA cores) and 4096 (split on both, the combine pass); [B]
    lengths with windows 0, 8, 64 and 100, and a scalar length."""
    _card()
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(70 + D)
    KV = 2
    for S in (32, 512, 4096):
        lens = _decode_lens(S)
        for G in (1, 4, 8, 16, 32):
            k, v = (_randn(rng, (len(lens), S, KV, D), dt) for _ in range(2))
            q = _randn(rng, (len(lens), KV * G, D), dt)
            for cl, window in ((lens, 0), (lens, 8), (lens, 64), (lens, 100), (S // 2 + 3, 0)):
                cl = torch.tensor(cl, dtype=torch.int32).cuda()
                got = tda.decode_attention_kernel(q, k, v, cl, window=window)
                want = tda.decode_attention_plain(q, k, v, cl, window=window)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                assert err <= tol, (S, G, window, err)
                assert got.dtype == dt and (got[cl.expand(len(lens)) == 0] == 0).all()


def _unaligned(x):
    """A contiguous copy of ``x`` whose data starts 2 bytes past a 16-byte
    boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    return buf[1:].view(x.shape).copy_(x)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [32, 512])
def test_contiguous_decode_unaligned_bf16_runs_on_the_cuda_cores(S):
    """bf16 tensors off the 16-byte boundary take the CUDA-core body: one
    block a row at S 32 (it writes out itself), split with the combine
    pass at 512; empty rows zero."""
    _card()
    rng = np.random.default_rng(75)
    H, KV, D = 32, 4, 64
    lens = [0, 1, 17, S - 1, S, S + 5]
    q, k, v = (_unaligned(_randn(rng, s, torch.bfloat16))
               for s in ((len(lens), H, D), (len(lens), S, KV, D), (len(lens), S, KV, D)))
    assert all(t.data_ptr() % 16 for t in (q, k, v))
    cl = torch.tensor(lens, dtype=torch.int32).cuda()
    for window in (0, 8):
        got = tda.decode_attention_kernel(q, k, v, cl, window=window)
        want = tda.decode_attention_plain(q, k, v, cl, window=window)
        torch.cuda.synchronize()
        assert (got.float() - want.float()).abs().max().item() <= 2e-2
        assert (got[0] == 0).all()


def _paged_decode_case(rng, dt, lens, H, KV, D, page, max_pages):
    """q, pools with spare pages and a permuted table giving each row the
    pages its length needs (capped at max_pages), every other entry a
    sentinel up to 1000 * row past num_pages; ``lens`` a list (a row
    each) or an int (three rows sharing one scalar length).  The values
    come from a card generator seeded from ``rng`` (pools of 4096
    positions a row are slow to draw on the host)."""
    rows = lens if isinstance(lens, list) else [lens] * 3
    need = [min(-(-max(n, 0) // page), max_pages) for n in rows]
    num_pages = sum(need) + 2
    ids = rng.permutation(num_pages)
    bt = np.full((len(rows), max_pages), num_pages, np.int32)
    for b, n in enumerate(need):
        bt[b, :n], ids = ids[:n], ids[n:]
        bt[b, n:] += 1000 * b
    gen = torch.Generator(device="cuda").manual_seed(int(rng.integers(2 ** 31)))
    q, kp, vp = (torch.randn(shape, generator=gen, device="cuda").to(dt)
                 for shape in ((len(rows), H, D), (num_pages, page, KV, D),
                               (num_pages, page, KV, D)))
    return q, kp, vp, torch.from_numpy(bt).cuda(), torch.tensor(lens, dtype=torch.int32).cuda()


# the paged decode's sweep: pages smaller than, equal to and larger than
# the 16-key tile; rows of one page, of 512 positions (one block a row on
# the tensor cores) and of 4096 (the combine pass)
PAGED_SWEEP_PAGES = (8, 16, 64, 128)
PAGED_SWEEP_S = (None, 512, 4096)  # None: one page a row


def _paged_decode_lens(S, page):
    """An empty row, one token, the 16-key tile edges, the page edges, S-1,
    S and a length past S."""
    return [0, 1, 15, 16, 17, page - 1, page, page + 1, 2 * page + 1, S - 1, S, S + 5]


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 32, 64, 96, 128])
@pytest.mark.parametrize("dtype,tol", TOLS)
def test_paged_decode_kernel_sweep(dtype, tol, D):
    """Pages 8, 16, 64 and 128; G 1, 4, 8, 16 and 32; rows of one page, of
    512 positions and of 4096; sentinels in every table; [B] lengths with
    windows 0, 1, 100 and past every length, and a scalar length; empty
    rows exactly zero."""
    _card()
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(80 + D)
    KV = 2
    for page in PAGED_SWEEP_PAGES:
        for S in PAGED_SWEEP_S:
            S = S or page
            lens = _paged_decode_lens(S, page)
            for G in (1, 4, 8, 16, 32):
                q, kp, vp, bt, cl = _paged_decode_case(rng, dt, lens, KV * G, KV, D, page,
                                                       S // page)
                for c, window in ((cl, 0), (cl, 1), (cl, 100), (cl, S + 5),
                                  (torch.tensor(S // 2 + 3, dtype=torch.int32).cuda(), 0)):
                    got = tda.decode_attention_paged_kernel(q, kp, vp, bt, c, window=window)
                    want = tda.decode_attention_paged_plain(q, kp, vp, bt, c, window=window)
                    torch.cuda.synchronize()
                    err = (got.float() - want.float()).abs().max().item()
                    assert err <= tol, (page, S, G, window, err)
                    assert got.dtype == dt and (got[c.expand(len(lens)) == 0] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("page,max_pages", [(16, 32), (64, 1)])
def test_paged_decode_unaligned_bf16_runs_on_the_cuda_cores(page, max_pages):
    """bf16 tensors off the 16-byte boundary take the CUDA-core body: split
    with the combine pass at 32 pages of 16, one block a row (it writes out
    itself) at one page of 64; windows 0 and 8; empty rows zero."""
    _card()
    rng = np.random.default_rng(85 + page)
    H, KV, D, S = 32, 4, 64, page * max_pages
    lens = [0, 1, 17, S - 1, S, S + 5]
    q, kp, vp, bt, cl = _paged_decode_case(rng, torch.bfloat16, lens, H, KV, D, page,
                                           max_pages)
    q, kp, vp = (_unaligned(t) for t in (q, kp, vp))
    assert all(t.data_ptr() % 16 for t in (q, kp, vp))
    assert not tda.paged_plan(torch.bfloat16, False, len(lens), KV, max_pages, page)[0]
    for window in (0, 8):
        got = tda.decode_attention_paged_kernel(q, kp, vp, bt, cl, window=window)
        want = tda.decode_attention_paged_plain(q, kp, vp, bt, cl, window=window)
        torch.cuda.synchronize()
        assert (got.float() - want.float()).abs().max().item() <= 2e-2
        assert (got[0] == 0).all()


# the serve engine's settings in chip_smoke.py (SERVE): slots, max_len,
# prefill chunk, page
SERVE_B, SERVE_S, SERVE_T, SERVE_PAGE = 8, 512, 64, 16


def _serving_shape_checks(arch, dtype, tol, seed, smoke=False):
    """The attention kernels ``arch``'s serving path reaches, at the shapes
    it gives them (``serving_attention_shapes``: H and KV after
    padded_gqa, the head dim per kernel; the serve engine's B, S, T and
    page), as chip_smoke.py's serving_shape_cases: a GQA stack's both
    decodes and both prefills, an MLA stack's contiguous decode alone;
    decode lengths over an empty row, the 16-key and 32-position tile
    edges, the page edges, the 64-key edge and a full row, in batches of
    B; full, partial, one-token and empty chunks (the contiguous one also
    a partial chunk running past S); caches bitwise, padding and empty
    rows exactly zero."""
    _card()
    from repro_torch.configs import get_config
    from repro_torch.models.lm import serving_attention_shapes
    shapes = serving_attention_shapes(get_config(arch, smoke=smoke))
    H, KV, D = shapes["decode_attention"]
    B, S, T, page = SERVE_B, SERVE_S, SERVE_T, SERVE_PAGE
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(seed)
    edges = [0, 1, 15, 16, 17, 31, 32, 33, 63, 64, 65, 100, 255, S - 17, S - 1, S]
    for i in range(0, len(edges), B):
        cl = torch.tensor(edges[i:i + B], dtype=torch.int32).cuda()
        q = _randn(rng, (B, H, D), dt)
        k, v = (_randn(rng, (B, S, KV, D), dt) for _ in range(2))
        got = tda.decode_attention_kernel(q, k, v, cl)
        want = tda.decode_attention_plain(q, k, v, cl)
        assert (got.float() - want.float()).abs().max().item() <= tol, (arch, cl)
        assert (got[cl == 0] == 0).all()
        if "decode_attention_paged" not in shapes:  # MLA: the contiguous decode only
            continue
        bt = torch.from_numpy(rng.permutation(B * S // page).astype(np.int32))
        bt = bt.cuda().reshape(B, S // page)
        kp, vp = (t.reshape(-1, page, KV, D) for t in (k, v))
        got = tda.decode_attention_paged_kernel(q, kp, vp, bt, cl)
        want = tda.decode_attention_paged_plain(q, kp, vp, bt, cl)
        assert (got.float() - want.float()).abs().max().item() <= tol, (arch, cl)
        assert (got[cl == 0] == 0).all()
    if "prefill_attention_paged" not in shapes:
        return
    base, clens = [0, 5, 64, 200, S - T, 13, 100, 3], [T, 3, T, 0, T, 1, T // 2 + 8, T]
    q, kn, vn, kp, vp, bt, bs, cls = _paged_case(rng, dt, B, T, H, KV, D, page, S // page,
                                                 base, clens)
    go, gk, gv = tpa.prefill_attention_paged_kernel(q, kn, vn, kp.clone(), vp.clone(),
                                                    bt, bs, cls)
    wo, wk, wv = tpa.prefill_attention_paged_plain(q, kn, vn, kp.clone(), vp.clone(),
                                                   bt, bs, cls)
    pad = torch.arange(T, device="cuda")[None, :] >= cls[:, None]
    assert torch.equal(gk, wk) and torch.equal(gv, wv) and bool((go[pad] == 0).all())
    assert (go.float() - wo.float()).abs().max().item() <= tol
    # the contiguous chunk at S - T/2 runs past S: its last 8 tokens drop
    base[-2] = S - T // 2
    bs = torch.tensor(base, dtype=torch.int32).cuda()
    kc, vc = (_randn(rng, (B, S, KV, D), dt) for _ in range(2))
    go, gk, gv = tpa.prefill_attention_kernel(q, kn, vn, kc.clone(), vc.clone(), bs, cls)
    wo, wk, wv = tpa.prefill_attention_plain(q, kn, vn, kc.clone(), vc.clone(), bs, cls)
    torch.cuda.synchronize()
    assert torch.equal(gk, wk) and torch.equal(gv, wv) and bool((go[pad] == 0).all())
    assert (go.float() - wo.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", TOLS)
def test_serving_kernels_at_phi3_mini_shapes(dtype, tol):
    """phi3-mini-3.8b's serving path: B 8, H 32, KV 32, D 96, S 512, T 64,
    page 16."""
    _serving_shape_checks("phi3-mini-3.8b", dtype, tol, seed=97)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", TOLS)
def test_serving_kernels_at_tinyllama_shapes(dtype, tol):
    """tinyllama-1.1b's serving path: B 8, H 32, KV 4, D 64, S 512, T 64,
    page 16."""
    _serving_shape_checks("tinyllama-1.1b", dtype, tol, seed=98)


@pytest.mark.cuda
@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("dtype,tol", TOLS)
def test_serving_kernels_at_minicpm3_shapes(dtype, tol, smoke):
    """minicpm3-4b's MLA serving path: the contiguous decode alone, on
    latents expanded per head: B 8, H 48, KV 48, D 96, S 512 (smoke: H 4,
    KV 4, D 24, padded to 32 in the tensor-core body)."""
    _serving_shape_checks("minicpm3-4b", dtype, tol, seed=99, smoke=smoke)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", TOLS)
def test_serving_kernels_at_moonshot_shapes(dtype, tol):
    """moonshot-v1-16b-a3b's serving path: B 8, H 16, KV 16, D 128, S 512,
    T 64, page 16."""
    _serving_shape_checks("moonshot-v1-16b-a3b", dtype, tol, seed=100)


def _within_limit(got, want, tol):
    """Every element within its limit of the plain value: ``tol`` for
    fp32; for bf16 the larger of ``tol`` and one bf16 ulp of |want|."""
    limit = torch.full_like(want, tol, dtype=torch.float32)
    if want.dtype == torch.bfloat16:
        _, e = torch.frexp(want.float().abs())
        limit = torch.clamp(torch.ldexp(torch.ones_like(limit), e - 8), min=tol)
    return bool(((got.float() - want.float()).abs() <= limit).all())


@pytest.mark.cuda
@pytest.mark.parametrize("T", [128, 256, 512])
@pytest.mark.parametrize("dtype,tol", TOLS)
def test_serving_kernels_at_fleet_prefill_shapes(dtype, tol, T):
    """The paged prefill at the widths a prefill-only engine of the fleet
    gives it (whole prompts up to max_len 512): tinyllama-1.1b's H 32, KV
    4, D 64, B 8, page 16, base 0, chunk lengths T, T - 1, T/2 + 1,
    T/2 - 1, 65, 17, 1 and 0 (across page and tile edges, an empty row);
    pools bitwise, padding and the empty row exactly zero, the output
    within the per-element limit."""
    _card()
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(60 + T)
    B, S, page, H, KV, D = SERVE_B, SERVE_S, SERVE_PAGE, 32, 4, 64
    base, clens = [0] * B, [T, T - 1, T // 2 + 1, T // 2 - 1, 65, 17, 1, 0]
    q, kn, vn, kp, vp, bt, bs, cl = _paged_case(rng, dt, B, T, H, KV, D, page, S // page,
                                                base, clens)
    go, gk, gv = tpa.prefill_attention_paged_kernel(q, kn, vn, kp.clone(), vp.clone(),
                                                    bt, bs, cl)
    wo, wk, wv = tpa.prefill_attention_paged_plain(q, kn, vn, kp.clone(), vp.clone(),
                                                   bt, bs, cl)
    torch.cuda.synchronize()
    assert torch.equal(gk, wk) and torch.equal(gv, wv)
    pad = torch.arange(T, device="cuda")[None, :] >= cl[:, None]
    assert bool((go[pad] == 0).all()) and bool((go[-1] == 0).all())
    assert _within_limit(go, wo, tol)


@pytest.mark.cuda
def test_seeded_draws_are_the_cpus_on_the_card():
    """The pipelines' threefry draws do not depend on the device: keys,
    bits and randint bitwise, uniforms bitwise, normals and the ETT series
    as on the CPU (which tests/test_torch_prng.py holds to JAX's)."""
    _card()
    from repro_torch.common import prng
    from repro_torch.models import forecasting as tf
    from repro_torch.models import hydrology as th

    key = prng.PRNGKey(3)
    for fn in (lambda d: prng.split(key.to(d), 5), lambda d: prng.fold_in(key.to(d), 7),
               lambda d: prng.random_bits(key, (64, 33), device=d),
               lambda d: prng.randint(key, 1000, 0, 2928, device=d),
               lambda d: prng.uniform(key, 4096, -1.0, 1.0, device=d)):
        assert torch.equal(fn("cuda").cpu(), fn("cpu"))
    n_gpu, n_cpu = prng.normal(key, 100_000, device="cuda").cpu(), prng.normal(key, 100_000)
    assert (n_gpu - n_cpu).abs().max().item() <= 2 * torch.finfo(torch.float32).eps
    ett = tf.make_ett_series(4096, seed=0, device="cuda").cpu()
    assert (ett - tf.make_ett_series(4096, seed=0, device="cpu")).abs().max().item() <= 1e-5
    (fg, tg), (fc, tc) = (th.make_camels_like(2000, device=d) for d in ("cuda", "cpu"))
    assert (fg.cpu() - fc).abs().max().item() <= 1e-5


@pytest.mark.cuda
def test_fleet_launches_its_kernels_and_keeps_the_streams():
    """A disaggregated 1 + 1 fleet of the tinyllama smoke config on the
    card, fp32, its engines stepping on threads of their own: the greedy
    streams equal one colocated engine's; only the paged kernels launch,
    the paged prefill exactly layers x the prefill engine's chunks, the
    paged decode exactly layers x the decode engine's steps, the scatter
    once a layer per chunk and per decode step."""
    _card()
    from repro_torch.common.params import init_params
    from repro_torch.configs import get_config
    from repro_torch.serve import Request, ServeEngine, build_fleet
    from repro_torch.train.state import model_specs

    cfg = get_config("tinyllama-1.1b", smoke=True).with_overrides(
        compute_dtype=torch.float32)
    params = init_params(torch.Generator(device="cuda").manual_seed(0),
                         model_specs(cfg), "cuda")
    rng = np.random.default_rng(8)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 17, 23, 40, 130, 9)]
    kw = dict(max_slots=4, max_len=256, page_size=16)
    direct = ServeEngine(cfg, params=params, **kw)
    want = [direct.submit(p, max_new_tokens=8) for p in prompts]
    direct.run_until_drained()
    _zero_counts()
    with build_fleet(cfg, num_engines=2, disaggregate=True, params=params, **kw) as router:
        reqs = [router.submit(Request(p, max_new_tokens=8)) for p in prompts]
        assert router.drain(timeout=300)
        stats = router.stats()
    torch.cuda.synchronize()
    c = _counts()
    pre, dec = stats["engines"]
    assert [r.tokens for r in reqs] == [w.tokens for w in want]
    assert c["paged_prefill"] == cfg.num_layers * pre["prefill_chunks"]
    assert c["paged_decode"] == cfg.num_layers * dec["decode_steps"]
    assert c["scatter"] == c["paged_prefill"] + c["paged_decode"]
    assert c["flash"] == c["decode"] == c["prefill"] == 0
    assert pre.get("decode_steps", 0) == 0 and dec.get("prefill_chunks", 0) == 0
    assert stats["handoff_pages"] == sum(-(-len(p) // 16) for p in prompts)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["minicpm3-4b", "moonshot-v1-16b-a3b"])
@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_mla_and_moe_engines_kernel_path_equals_plain_path(arch, layout):
    """The smoke MLA and MoE engines on the card in fp32: the kernel path's
    greedy streams equal the plain path's, token for token, and the path
    launched its kernels (MLA: the contiguous decode alone, on either
    layout)."""
    _card()
    from repro_torch.common.params import init_params
    from repro_torch.configs import get_config
    from repro_torch.serve import ServeEngine
    from repro_torch.train.state import model_specs
    cfg = get_config(arch, smoke=True).with_overrides(compute_dtype=torch.float32)
    params = init_params(torch.Generator(device="cuda").manual_seed(0), model_specs(cfg),
                         "cuda")
    rng = np.random.default_rng(5)
    work = [(rng.integers(1, 250, n).astype(np.int32), 12) for n in (5, 40, 9, 100)]
    streams = {}
    counters = (tda.decode_attention_kernel, tda.decode_attention_paged_kernel,
                tpa.prefill_attention_kernel, tpa.prefill_attention_paged_kernel)
    for impl in ("auto", "ref"):
        for fn in counters:
            fn.launches = 0
        eng = ServeEngine(cfg, params=params, max_slots=4, max_len=256, kv_layout=layout,
                          decode_impl=impl)
        reqs = [eng.submit(p, max_new_tokens=g) for p, g in work]
        eng.run_until_drained()
        streams[impl] = [r.tokens for r in reqs]
        launched = {fn.__name__ for fn in counters if fn.launches}
        if impl == "ref":
            assert not launched
        elif cfg.attention == "mla":
            assert launched == {"decode_attention_kernel"}
        else:
            assert launched == ({"decode_attention_paged_kernel",
                                 "prefill_attention_paged_kernel"} if layout == "paged"
                                else {"decode_attention_kernel", "prefill_attention_kernel"})
    assert streams["auto"] == streams["ref"]


@pytest.mark.cuda
def test_a_compacted_chunk_writes_what_the_full_slab_writes():
    """One paged chunk step of phi3-mini's smoke config at head dim 96 in
    bf16, over 8 slots of 8 pages of 16 whose pools hold noise, run twice
    from the same pools: the full slab (every slot a row; slots 1, 2 and 5
    take 40, 64 and 23 tokens at bases 16, 0 and 37) and the compacted one
    (those three rows and a filler: chunk length 0, an all-sentinel table
    row).  The real rows' pages are within one bf16 ulp (or 2e-2) of the
    full slab's, every other page is bitwise untouched by either, and the
    real rows' last logits are within 2% of the full slab's largest."""
    _card()
    from repro_torch.common.params import init_params, map_tree, tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.models.lm import lm_paged_cache_specs
    from repro_torch.serve.engine import _map_cache
    from repro_torch.train.state import model_specs
    from repro_torch.train.step import make_prefill_chunk_step
    cfg = get_config("phi3-mini-3.8b", smoke=True).with_overrides(head_dim=96)
    assert cfg.compute_dtype == torch.bfloat16
    params = init_params(torch.Generator(device="cuda").manual_seed(0), model_specs(cfg),
                         "cuda")
    run = map_tree(lambda t: t.to(cfg.compute_dtype), params)  # as the engine casts
    S, page, mp, T = 8, 16, 8, 64
    rng = np.random.default_rng(32)
    gen = torch.Generator(device="cuda").manual_seed(1)
    pools = map_tree(lambda p: torch.randn(p.shape, generator=gen, device="cuda").to(p.dtype),
                     lm_paged_cache_specs(cfg, S * mp, page))
    table = rng.permutation(S * mp).astype(np.int32).reshape(S, mp)
    real = {1: (16, 40), 2: (0, 64), 5: (37, 23)}  # slot: (base, take)
    prompt = {i: rng.integers(1, cfg.vocab_size, take).astype(np.int32)
              for i, (_, take) in real.items()}
    step = make_prefill_chunk_step(cfg)

    def chunk(slots, R):
        tok, base, clen = np.zeros((R, T), np.int32), np.zeros(R, np.int32), np.zeros(R, np.int32)
        bt = np.full((R, mp), S * mp, np.int32)
        for r, i in enumerate(slots):
            bt[r] = table[i]
            if i in real:
                base[r], clen[r] = real[i]
                tok[r, :clen[r]] = prompt[i]
        cache = map_tree(torch.clone, pools)
        _, last, cache = step(run, *(torch.from_numpy(a).cuda() for a in (tok, base, clen)),
                              cache, torch.from_numpy(bt).cuda())
        return last, cache

    full_last, full = chunk(range(S), S)
    last, compact = chunk(sorted(real), 4)
    torch.cuda.synchronize()
    owned = torch.from_numpy(table[sorted(real)].reshape(-1)).long()
    keep = torch.ones(S * mp, dtype=torch.bool)
    keep[owned] = False
    # every pool as [layers, pages, ...]
    layered = (tree_leaves(_map_cache(lambda x: x[None], lambda x: x, t))
               for t in (pools, full, compact))
    for b, f, c in zip(*layered):
        assert torch.equal(b[:, keep], f[:, keep]) and torch.equal(b[:, keep], c[:, keep])
        assert _within_limit(c[:, owned], f[:, owned], 2e-2)
        print("pages: bitwise", torch.equal(c[:, owned], f[:, owned]),
              "max diff", (c[:, owned].float() - f[:, owned].float()).abs().max().item())
    want, got = full_last[sorted(real)].float(), last[:3].float()
    gap = (got - want).abs().max().item()
    print("last logits: max diff", gap, "largest", want.abs().max().item())
    assert gap <= 2e-2 * want.abs().max().item()


@pytest.mark.cuda
def test_sampling_on_the_card_matches_the_cpu():
    """threefry's split keys, bits and uniforms on the card equal the CPU's
    bitwise, seeds >= 2^32 among them, and so do sample_tokens' tokens."""
    _card()
    from repro_torch.serve import sampling as ts
    seeds = [0, 1, 2**32 - 1, 2**32, 2**40 + 3, 2**63 - 1]
    keys = torch.from_numpy(np.stack([ts.make_slot_key(s) for s in seeds]).astype(np.int64))
    n = 32000
    for fn in (lambda k: ts.split(k, 2), lambda k: ts.random_bits(k, n),
               lambda k: ts.uniform(k, n, 1e-38, 1.0)):
        assert torch.equal(fn(keys.cuda()).cpu(), fn(keys))
    logits = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (len(seeds), n)).astype(np.float32))
    temp = torch.tensor([0.0, 1.0, 0.5, 2.0, 1.0, 0.7])
    topk = torch.tensor([0, 0, 5, 1, 50, 0], dtype=torch.int32)
    got = ts.sample_tokens(logits.cuda(), keys.cuda(), temp.cuda(), topk.cuda())
    want = ts.sample_tokens(logits, keys, temp, topk)
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 15, 16, 17, 64])
@pytest.mark.parametrize("dtype,tol", TOLS)
def test_contiguous_prefill_kernel_sweep(dtype, tol, T):
    """Full tinyllama widths (G 8, D 64) over the paged prefill's sweep:
    bases 0, 5, 16, 447 and 500 with full, partial and empty chunks, at
    S 512 (the chunk at 500 runs past the row: its tail drops and it
    attends the whole row); caches bitwise, padding rows exactly zero."""
    _card()
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(80 + T)
    B, H, KV, D, S = 6, 32, 4, 64, 512
    q, kn, vn = (_randn(rng, s, dt) for s in ((B, T, H, D), (B, T, KV, D), (B, T, KV, D)))
    kc, vc = (_randn(rng, (B, S, KV, D), dt) for _ in range(2))
    bs = torch.tensor([0, 5, 16, 447, 500, 3], dtype=torch.int32).cuda()
    cl = torch.tensor([T, max(T - 3, 0), T, T, T, 0], dtype=torch.int32).cuda()
    go, gk, gv = tpa.prefill_attention_kernel(q, kn, vn, kc.clone(), vc.clone(), bs, cl)
    wo, wk, wv = tpa.prefill_attention_plain(q, kn, vn, kc.clone(), vc.clone(), bs, cl)
    torch.cuda.synchronize()
    assert torch.equal(gk, wk) and torch.equal(gv, wv)
    pad = torch.arange(T, device="cuda")[None, :] >= cl[:, None]
    assert bool((go[pad] == 0).all())
    assert (go.float() - wo.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("G,D", [(1, 16), (4, 32), (8, 128), (128, 64), (1, 96), (8, 96)])
def test_contiguous_prefill_kernel_other_widths(G, D):
    """bf16 at other GQA groups and head dims: G 128 (two tiles a token),
    D 16, 32, 96 and 128."""
    _card()
    rng = np.random.default_rng(90 + D)
    B, T, KV, S = 3, 17, 2, 128
    q, kn, vn = (_randn(rng, s, torch.bfloat16)
                 for s in ((B, T, KV * G, D), (B, T, KV, D), (B, T, KV, D)))
    kc, vc = (_randn(rng, (B, S, KV, D), torch.bfloat16) for _ in range(2))
    bs, cl = (torch.tensor(a, dtype=torch.int32).cuda() for a in ([0, 21, 120], [17, 9, 0]))
    go, gk, gv = tpa.prefill_attention_kernel(q, kn, vn, kc.clone(), vc.clone(), bs, cl)
    wo, wk, wv = tpa.prefill_attention_plain(q, kn, vn, kc.clone(), vc.clone(), bs, cl)
    torch.cuda.synchronize()
    assert torch.equal(gk, wk) and torch.equal(gv, wv)
    assert (go.float() - wo.float()).abs().max().item() <= 2e-2
    assert (go[1, 9:] == 0).all() and (go[2] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", TOLS)
def test_attention_kernels_at_head_dim_96(dtype, tol):
    """phi3-mini's head dim in all five attention kernels against their
    plain versions: flash at G 1 and 8, causal and full; both prefills
    and both decodes with ragged lengths (caches bitwise)."""
    _card()
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(96)
    D, KV, page = 96, 2, 16
    for G in (1, 8):
        H = KV * G
        for causal in (True, False):
            q, k, v = (_randn(rng, (2, 130, n, D), dt).transpose(1, 2) for n in (H, KV, KV))
            got = tfa.flash_attention_kernel(q, k, v, causal=causal)
            want = tfa.flash_attention_plain(q, k, v, causal=causal)
            assert (got.float() - want.float()).abs().max().item() <= tol
        lens = [0, 1, 17, 100, 255, 256]
        q = _randn(rng, (len(lens), H, D), dt)
        k, v = (_randn(rng, (len(lens), 256, KV, D), dt) for _ in range(2))
        cl = torch.tensor(lens, dtype=torch.int32).cuda()
        got = tda.decode_attention_kernel(q, k, v, cl)
        assert (got.float() - tda.decode_attention_plain(q, k, v, cl).float()).abs().max() <= tol
        bt = torch.arange(len(lens) * 16, dtype=torch.int32).cuda().reshape(len(lens), 16)
        kp, vp = (t.reshape(-1, page, KV, D) for t in (k, v))
        got = tda.decode_attention_paged_kernel(q, kp, vp, bt, cl)
        want = tda.decode_attention_paged_plain(q, kp, vp, bt, cl)
        assert (got.float() - want.float()).abs().max().item() <= tol
        base, clens = [0, 30, 200], [17, 5, 0]
        args = _paged_case(rng, dt, 3, 17, H, KV, D, page, 16, base, clens)
        q, kn, vn, kp, vp, bt, bs, cl = args
        go, gk, gv = tpa.prefill_attention_paged_kernel(q, kn, vn, kp.clone(), vp.clone(),
                                                        bt, bs, cl)
        wo, wk, wv = tpa.prefill_attention_paged_plain(q, kn, vn, kp.clone(), vp.clone(),
                                                       bt, bs, cl)
        assert torch.equal(gk, wk) and torch.equal(gv, wv)
        assert (go.float() - wo.float()).abs().max().item() <= tol
        kc, vc = (_randn(rng, (3, 256, KV, D), dt) for _ in range(2))
        go, gk, gv = tpa.prefill_attention_kernel(q, kn, vn, kc.clone(), vc.clone(), bs, cl)
        wo, wk, wv = tpa.prefill_attention_plain(q, kn, vn, kc.clone(), vc.clone(), bs, cl)
        torch.cuda.synchronize()
        assert torch.equal(gk, wk) and torch.equal(gv, wv)
        assert (go.float() - wo.float()).abs().max().item() <= tol
        assert (go[1, 5:] == 0).all() and (go[2] == 0).all()


@pytest.mark.cuda
def test_contiguous_paths_make_no_host_sync():
    """The contiguous prefill wrapper (scatter + attention) and the decode
    at the serving shape run under sync-debug "error": a host sync would
    raise.  Each launches once."""
    _card()
    rng = np.random.default_rng(61)
    B, T, H, KV, D, S = 4, 64, 32, 4, 64, 512
    q, kn, vn = (_randn(rng, s, torch.bfloat16)
                 for s in ((B, T, H, D), (B, T, KV, D), (B, T, KV, D)))
    kc, vc = (_randn(rng, (B, S, KV, D), torch.bfloat16) for _ in range(2))
    bs, cl = (torch.tensor(a, dtype=torch.int32).cuda() for a in ([64, 0, 0, 0], [64, 0, 5, 0]))
    qd = _randn(rng, (B, H, D), torch.bfloat16)
    lens = torch.tensor([128, 1, 5, 0], dtype=torch.int32).cuda()
    torch.cuda.synchronize()
    n_pf, n_dec = tpa.prefill_attention_kernel.launches, tda.decode_attention_kernel.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        tpa.prefill_attention_kernel(q, kn, vn, kc, vc, bs, cl)
        tda.decode_attention_kernel(qd, kc, vc, lens)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert tpa.prefill_attention_kernel.launches == n_pf + 1
    assert tda.decode_attention_kernel.launches == n_dec + 1


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
    """The paged prefill wrapper (scatter + attention), the decode append
    and the paged decode on the kernel run under sync-debug "error": a
    host sync would raise.  The append equals the plain one bitwise."""
    _card()
    rng = np.random.default_rng(60)
    q, kn, vn, kp, vp, bt, bs, cl = _paged_case(
        rng, torch.bfloat16, 4, 64, 32, 4, 64, 16, 8, [64, 0, 0, 0], [64, 0, 5, 0])
    idx = torch.tensor([5, 17, -1, 127], dtype=torch.int32).cuda()
    kr, vr = (_randn(rng, (4, 4, 64), torch.bfloat16) for _ in range(2))
    wk, wv = tops.paged_append(kp.clone(), vp.clone(), bt, idx, kr, vr, impl="ref")
    gk, gv = kp.clone(), vp.clone()
    qd = _randn(rng, (4, 32, 64), torch.bfloat16)
    torch.cuda.synchronize()
    launches = tpa.write_chunk_paged_kernel.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        tpa.prefill_attention_paged_kernel(q, kn, vn, kp, vp, bt, bs, cl)
        tops.paged_append(gk, gv, bt, idx, kr, vr)
        tda.decode_attention_paged_kernel(qd, gk, gv, bt, cl, window=16)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert tpa.write_chunk_paged_kernel.launches == launches + 2
    assert torch.equal(gk, wk) and torch.equal(gv, wv)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_mla_path_makes_no_host_sync(layout):
    """minicpm3's smoke MLA block on the card under sync-debug "error": the
    ragged prefill's latent writes and attention, the decode's latent
    append, gather, expansion and kernel 2 (a host sync would raise)."""
    _card()
    from repro_torch.common.params import init_params
    from repro_torch.configs import get_config
    from repro_torch.models import blocks as tb
    cfg = get_config("minicpm3-4b", smoke=True)
    p = init_params(torch.Generator(device="cuda").manual_seed(0), tb.mla_specs(cfg), "cuda")
    B, S, page = 4, 64, 16
    if layout == "paged":
        cache = {"ckv_pages": torch.zeros(B * S // page, page, cfg.kv_lora_rank),
                 "kpe_pages": torch.zeros(B * S // page, page, cfg.rope_head_dim),
                 "block_table": torch.arange(B * S // page, dtype=torch.int32).reshape(B, -1)}
    else:
        cache = {"c_kv": torch.zeros(B, S, cfg.kv_lora_rank),
                 "k_pe": torch.zeros(B, S, cfg.rope_head_dim)}
    cache = {k: v.cuda() if k == "block_table" else v.to("cuda", cfg.compute_dtype)
             for k, v in cache.items()}
    x = torch.randn(B, 8, cfg.d_model, device="cuda").to(cfg.compute_dtype)
    base = torch.tensor([0, 3, 9, 0], dtype=torch.int32).cuda()
    clens = torch.tensor([8, 0, 2, 5], dtype=torch.int32).cuda()
    pos = base[:, None] + torch.arange(8, dtype=torch.int32, device="cuda")[None]
    launches = tda.decode_attention_kernel.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, cache = tb.mla_apply(cfg, p, x, pos, dict(cache, len=base), chunk_lens=clens)
        lens = base + clens
        y, _ = tb.mla_apply(cfg, p, x[:, :1], lens[:, None], dict(cache, len=lens))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert tda.decode_attention_kernel.launches == launches + 1
    assert bool(torch.isfinite(y.float()).all())


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


def _counts():
    return {"flash": tfa.flash_attention_kernel.launches,
            "paged_decode": tda.decode_attention_paged_kernel.launches,
            "paged_prefill": tpa.prefill_attention_paged_kernel.launches,
            "scatter": tpa.write_chunk_paged_kernel.launches,
            "decode": tda.decode_attention_kernel.launches,
            "prefill": tpa.prefill_attention_kernel.launches}


def _zero_counts():
    for fn in (tfa.flash_attention_kernel, tda.decode_attention_paged_kernel,
               tpa.prefill_attention_paged_kernel, tpa.write_chunk_paged_kernel,
               tda.decode_attention_kernel, tpa.prefill_attention_kernel):
        fn.launches = 0


@pytest.mark.cuda
def test_runtime_entry_points_launch_their_kernels(tmp_path):
    """The training entry point's stage graph and a service stage, on the card
    at the tinyllama smoke config through the port's Session: flash
    attention launches 2 x layers per step and nothing else does; the
    service launches the paged kernels alone (the scatter once per
    prefill call and decode append), with the streams the direct engine
    gives."""
    _card()
    from repro_torch.common.params import init_params
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.core import Session, stage
    from repro_torch.launch import train as tlaunch
    from repro_torch.serve import Request, RequestState, ServeEngine
    from repro_torch.train.state import model_specs

    steps = 3
    args = tlaunch.build_parser().parse_args(
        ["--arch", "tinyllama-1.1b", "--smoke", "--steps", str(steps), "--batch", "2",
         "--seq", "64", "--ckpt-dir", str(tmp_path / "ckpt")])
    _zero_counts()
    res = tlaunch.run(args)
    torch.cuda.synchronize()
    layers = get_config("tinyllama-1.1b", smoke=True).num_layers
    assert _counts() == {"flash": 2 * layers * steps, "paged_decode": 0,
                         "paged_prefill": 0, "scatter": 0, "decode": 0, "prefill": 0}
    assert res["steps"] == steps and np.isfinite(res["last_loss"])

    cfg = get_config("tinyllama-1.1b", smoke=True).with_overrides(
        compute_dtype=torch.float32)
    params = init_params(torch.Generator(device="cuda").manual_seed(0),
                         model_specs(cfg), "cuda")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32) for n in (5, 40, 9)]
    direct = ServeEngine(cfg, RunConfig(), params=params, max_slots=2, max_len=64)
    want = [direct.submit(p, max_new_tokens=8) for p in prompts]
    direct.run_until_drained()
    eng = ServeEngine(cfg, RunConfig(), params=params, max_slots=2, max_len=64)

    @stage(kind="inference", service=True)
    def engine(ctx):
        return eng.run_service(ctx.control, resume_state=ctx.resume_state)

    _zero_counts()
    with Session() as session:
        handle = session.serve(engine, name="serve")
        reqs = [handle.submit_request(Request(p, max_new_tokens=8)) for p in prompts]
        assert handle.stop(drain=True, timeout=120)
    torch.cuda.synchronize()
    c = _counts()
    assert all(r.state is RequestState.DONE for r in reqs)
    assert [r.tokens for r in reqs] == [w.tokens for w in want]
    assert c["paged_decode"] > 0 and c["paged_prefill"] > 0
    assert c["scatter"] == c["paged_decode"] + c["paged_prefill"]
    assert c["flash"] == c["decode"] == c["prefill"] == 0


# -- the recurrent families (xlstm, recurrentgemma) ---------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", TOLS)
def test_contiguous_decode_kernel_at_recurrentgemma_ring_shapes(dtype, tol):
    """recurrentgemma's ring decode (lm.serving_attention_shapes: H 16, KV 1,
    D 256 at full width; H 4, KV 1, D 16 at smoke width) over a ring of
    2048 (16) slots, B 8: lengths across the 16-key tile, the 512-position
    span and the ring's end, in [B] and scalar form; empty rows exactly
    zero."""
    _card()
    from repro_torch.configs import get_config
    from repro_torch.models.lm import serving_attention_shapes
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(256)
    for smoke, S in ((False, 2048), (True, 16)):
        H, KV, D = serving_attention_shapes(
            get_config("recurrentgemma-9b", smoke=smoke))["decode_attention"]
        edges = sorted({min(n, S) for n in (0, 1, 15, 16, 17, 511, 512, 513, 1023, 1024,
                                           1025, S - 1, S, S, S, S)})
        rows = [edges[i:i + 8] for i in range(0, len(edges), 8)]
        for lens in rows + [S, S // 2 + 1]:
            B = 8
            cl = (torch.tensor((lens + [S] * B)[:B], dtype=torch.int32) if isinstance(lens, list)
                  else torch.tensor(lens, dtype=torch.int32)).cuda()
            q = _randn(rng, (B, H, D), dt)
            k, v = (_randn(rng, (B, S, KV, D), dt) for _ in range(2))
            got = tda.decode_attention_kernel(q, k, v, cl)
            want = tda.decode_attention_plain(q, k, v, cl)
            torch.cuda.synchronize()
            assert (got.float() - want.float()).abs().max().item() <= tol, (smoke, lens)
            assert (got[cl.expand(B) == 0] == 0).all()


def _smoke_lm(arch, dtype=torch.float32):
    from repro_torch.common.params import init_params
    from repro_torch.configs import get_config
    from repro_torch.train.state import model_specs
    cfg = get_config(arch, smoke=True).with_overrides(compute_dtype=dtype)
    return cfg, init_params(torch.Generator(device="cuda").manual_seed(0),
                            model_specs(cfg), "cuda")


@pytest.mark.cuda
def test_recurrent_paths_launch_what_they_should():
    """On the card: an xlstm train step and recurrentgemma's no-cache
    prefill launch no port kernel (JAX's paths run no Pallas kernel
    there); recurrentgemma's decode steps launch kernel 2 once per local
    layer a step and nothing else, through a wrap of its 16-slot ring;
    the kernel path's greedy stream equals the plain path's (fp32)."""
    _card()
    from repro_torch.common.params import map_tree
    from repro_torch.configs import RunConfig, block_pattern
    from repro_torch.models.lm import lm_cache_specs
    from repro_torch.train.state import init_train_state
    from repro_torch.train.step import make_decode_step, make_prefill_step, make_train_step
    from repro_torch.configs import get_config
    xcfg = get_config("xlstm-125m", smoke=True)
    state = init_train_state(torch.Generator(device="cuda").manual_seed(0), xcfg,
                             RunConfig(), device="cuda")
    tok = torch.randint(0, xcfg.vocab_size, (2, 32), device="cuda", dtype=torch.int32)
    _zero_counts()
    _, m = make_train_step(xcfg, RunConfig())(state, {"tokens": tok,
                                                      "labels": torch.roll(tok, -1, 1)})
    torch.cuda.synchronize()
    assert np.isfinite(m["loss"].item()) and not any(_counts().values())

    cfg, params = _smoke_lm("recurrentgemma-9b")
    head, unit, reps, tail = block_pattern(cfg)
    n_local = sum(tk == "local" for tk, _ in head + tail) + reps * sum(
        tk == "local" for tk, _ in unit)
    B, steps = 2, 40
    last = make_prefill_step(cfg)(params, {"tokens": tok})
    torch.cuda.synchronize()
    assert last.shape == (2, cfg.padded_vocab) and not any(_counts().values())
    streams = {}
    for impl in ("auto", "ref"):
        c = cfg.with_overrides(decode_impl=impl)
        cache = map_tree(lambda p: torch.zeros(p.shape, dtype=p.dtype, device="cuda"),
                         lm_cache_specs(c, B, 64))
        dec = make_decode_step(c)
        t = tok[:, :1]
        out = []
        _zero_counts()
        for i in range(steps):
            t, _, cache = dec(params, t[:, None] if t.ndim == 1 else t, cache,
                              torch.full((B,), i, dtype=torch.int32, device="cuda"))
            out.append(t)
        torch.cuda.synchronize()
        want = {"decode": n_local * steps if impl == "auto" else 0}
        assert _counts() == {**{k: 0 for k in _counts()}, **want}, impl
        streams[impl] = torch.stack(out).cpu()
    assert torch.equal(streams["auto"], streams["ref"])


@pytest.mark.cuda
@pytest.mark.parametrize("per_slot", [False, True])
def test_ring_decode_makes_no_host_sync(per_slot):
    """recurrentgemma's decode step (smoke, bf16) on the card under
    sync-debug "error": the ring writes, kernel 2 over the clamped lengths
    and the RG-LRU steps make no host sync (one would raise)."""
    _card()
    from repro_torch.common.params import map_tree
    from repro_torch.models.lm import lm_cache_specs
    from repro_torch.train.step import make_decode_step
    cfg, params = _smoke_lm("recurrentgemma-9b", torch.bfloat16)
    B = 3
    cache = map_tree(lambda p: torch.zeros(p.shape, dtype=p.dtype, device="cuda"),
                     lm_cache_specs(cfg, B, 64))
    dec = make_decode_step(cfg)
    tok = torch.ones((B, 1), dtype=torch.int32, device="cuda")
    lens = [(torch.full((B,), i, dtype=torch.int32) if per_slot else torch.tensor(i)).cuda()
            for i in range(20)]
    torch.cuda.synchronize()
    _zero_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for n in lens:  # through a wrap of the 16-slot ring
            nxt, _, cache = dec(params, tok, cache, n)
            tok = nxt[:, None]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert tda.decode_attention_kernel.launches == 20


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", TOLS)
def test_kernels_at_whisper_encoder_and_cross_shapes(dtype, tol):
    """whisper-medium's shapes (lm.serving_attention_shapes: H 16, KV 16,
    D 64): flash full over 1500 frames (B 2) and causal over the
    decoder's 187 tokens; kernel 2 over the cross cache [B 4, 1500, 16,
    64] at scalar lengths past one 512-position span (split spans and the
    combine pass) and over the self cache [B 4, 448, 16, 64]."""
    _card()
    from repro_torch.configs import get_config
    from repro_torch.models.lm import serving_attention_shapes
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(1500)
    H, KV, D = serving_attention_shapes(get_config("whisper-medium"))["decode_attention"]
    assert (H, KV, D) == (16, 16, 64)
    for S, causal in ((1500, False), (187, True)):
        q, k, v = (_randn(rng, (2, S, n, D), dt).transpose(1, 2) for n in (H, KV, KV))
        got = tfa.flash_attention_kernel(q, k, v, causal=causal)
        want = tfa.flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert (got.float() - want.float()).abs().max().item() <= tol, (S, causal)
    for S, lens in ((1500, (1, 511, 512, 513, 1024, 1499, 1500)),
                    (448, (0, 1, 15, 16, 17, 447, 448))):
        q = _randn(rng, (4, H, D), dt)
        k, v = (_randn(rng, (4, S, KV, D), dt) for _ in range(2))
        for n in lens:
            cl = torch.tensor(n, dtype=torch.int32).cuda()
            got = tda.decode_attention_kernel(q, k, v, cl)
            want = tda.decode_attention_plain(q, k, v, cl)
            torch.cuda.synchronize()
            assert (got.float() - want.float()).abs().max().item() <= tol, (S, n)
            assert n or (got == 0).all()


def _whisper_cache(cfg, params, B, frames, max_len=32):
    from repro_torch.common.params import map_tree
    from repro_torch.models import encdec
    from repro_torch.train.state import cache_specs
    cache = map_tree(lambda p: torch.zeros(p.shape, dtype=p.dtype, device="cuda"),
                     cache_specs(cfg, B, max_len))
    with torch.no_grad():
        cross = encdec.precompute_cross_cache(cfg, params, encdec.encode(cfg, params, frames,
                                                                         remat=False))
    for name in ("xk", "xv"):
        cache["dec_unit"]["b0"][name].copy_(cross["b0"][name])
    return cache


@pytest.mark.cuda
def test_encdec_and_mrope_paths_launch_what_they_should():
    """Smoke width on the card: a whisper train step launches flash exactly
    2 x (encoder + decoder layers) times (full and causal, again under
    remat) and nothing else; its decode steps kernel 2 exactly twice a
    layer (self and cross), nothing else, the fp32 stream equal to the
    plain path's; qwen2-vl's empty-cache prefill on embeddings launches
    flash once a layer and its M-RoPE decode step kernel 2 once a layer."""
    _card()
    from repro_torch.common.params import map_tree
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.models.lm import lm_apply, lm_cache_specs
    from repro_torch.train.state import init_train_state
    from repro_torch.train.step import make_decode_step, make_train_step
    cfg = get_config("whisper-medium", smoke=True)
    L = cfg.num_layers + cfg.num_decoder_layers
    state = init_train_state(torch.Generator(device="cuda").manual_seed(0), cfg, RunConfig())
    frames = torch.randn(2, 1500, cfg.d_model, device="cuda")
    tok = torch.randint(0, cfg.vocab_size, (2, 187), device="cuda", dtype=torch.int32)
    _zero_counts()
    _, m = make_train_step(cfg, RunConfig())(state, {"frames": frames, "tokens": tok,
                                                     "labels": torch.roll(tok, -1, 1)})
    torch.cuda.synchronize()
    assert np.isfinite(m["loss"].item())
    assert _counts() == {**{k: 0 for k in _counts()}, "flash": 2 * L}
    streams = {}
    for impl in ("auto", "ref"):
        c = cfg.with_overrides(compute_dtype=torch.float32, decode_impl=impl)
        cache = _whisper_cache(c, state["params"], 2, frames)
        dec = make_decode_step(c)
        t, out = tok[:, :1], []
        _zero_counts()
        for i in range(12):
            nxt, _, cache = dec(state["params"], t, cache, torch.tensor(i).cuda())
            out.append(nxt)
            t = nxt[:, None]
        torch.cuda.synchronize()
        want = 2 * cfg.num_decoder_layers * 12 if impl == "auto" else 0
        assert _counts() == {**{k: 0 for k in _counts()}, "decode": want}, impl
        streams[impl] = torch.stack(out).cpu()
    assert torch.equal(streams["auto"], streams["ref"])

    qcfg, params = _smoke_lm("qwen2-vl-72b")
    B, S = 2, 40
    pos = torch.arange(S, dtype=torch.int32, device="cuda")[None, :, None].repeat(B, 1, 3)
    pos[:, 8:24, 1] += torch.arange(16, device="cuda", dtype=torch.int32) // 4
    pos[:, 8:24, 2] += torch.arange(16, device="cuda", dtype=torch.int32) % 4
    cache = map_tree(lambda p: torch.zeros(p.shape, dtype=p.dtype, device="cuda"),
                     lm_cache_specs(qcfg, B, 64))
    emb = torch.randn(B, S, qcfg.d_model, device="cuda")
    _zero_counts()
    with torch.no_grad():
        lm_apply(qcfg, params, emb, pos, cache, 0, remat=False)
        torch.cuda.synchronize()
        assert _counts() == {**{k: 0 for k in _counts()}, "flash": qcfg.num_layers}
        _zero_counts()
        make_decode_step(qcfg)(params, tok[:, :1], cache, torch.tensor(S).cuda())
    torch.cuda.synchronize()
    assert _counts() == {**{k: 0 for k in _counts()}, "decode": qcfg.num_layers}


@pytest.mark.cuda
def test_whisper_decode_step_makes_no_host_sync():
    """whisper's decode step (smoke, bf16) on the card under sync-debug
    "error": the self cache write at a 0-d device length, kernel 2 over
    the self and the cross cache, the greedy pick (a host sync would
    raise)."""
    _card()
    from repro_torch.train.step import make_decode_step
    cfg, params = _smoke_lm("whisper-medium", torch.bfloat16)
    frames = torch.randn(3, 1500, cfg.d_model, device="cuda")
    cache = _whisper_cache(cfg, params, 3, frames)
    dec = make_decode_step(cfg)
    tok = torch.ones((3, 1), dtype=torch.int32, device="cuda")
    lens = [torch.tensor(i).cuda() for i in range(10)]
    torch.cuda.synchronize()
    _zero_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            for n in lens:
                nxt, _, cache = dec(params, tok, cache, n)
                tok = nxt[:, None]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert tda.decode_attention_kernel.launches == 2 * cfg.num_decoder_layers * 10


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", TOLS)
def test_paged_kernels_in_a_worker_process_match_plain(dtype, tol):
    """Kernel 5 (the paged prefill and its cache scatter) and kernel 3
    (the paged decode) launched by a worker process of the subprocess
    transport, with its own CUDA context, on inputs made here: each held
    to its plain version there, the pools written identically, and the
    launches counted in the worker (the parent's counters stay 0)."""
    _card()
    import torch_exec_tasks as T
    from repro_torch.core.exec import SubprocessTransport
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(11)
    B, T_, H, KV, D, page, mp = 3, 64, 32, 4, 64, 16, 8
    num_pages = B * mp + 1
    bt = rng.permutation(num_pages)[:B * mp].reshape(B, mp).astype(np.int32)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dt)

    base, clens = np.array([0, 37, 100], np.int32), np.array([64, 20, 1], np.int32)
    case = {"q": randn(B, T_, H, D), "k_new": randn(B, T_, KV, D),
            "v_new": randn(B, T_, KV, D), "k_pages": randn(num_pages, page, KV, D),
            "v_pages": randn(num_pages, page, KV, D),
            "block_table": torch.from_numpy(bt), "base": torch.from_numpy(base),
            "chunk_lens": torch.from_numpy(clens), "q_dec": randn(B, H, D),
            "lens": torch.from_numpy(base + clens)}
    before = T.launch_counts()
    pool = SubprocessTransport(max_workers=1, worker_devices=1)
    try:
        out = pool.submit(T.run_paged_kernels, case).result(timeout=600)
    finally:
        pool.shutdown()
    assert out["pid"] != os.getpid()
    assert out["prefill_err"] <= tol and out["decode_err"] <= tol and out["pages_equal"]
    assert out["launches"] == {**{k: 0 for k in out["launches"]},
                               "prefill_attention_paged": 1, "paged_scatter": 1,
                               "decode_attention_paged": 1}
    assert T.launch_counts() == before


# the process mesh's collectives at world 2 on the card: two gloo rank
# processes, each with its own CUDA context (tests/torch_dist_ranks.py
# ``card`` at a small size: the smoke config's gradient tree, tables of
# 2^16 rows)
CARD2_SPEC = {"device": "cuda", "seed": 0, "df_rows": 1 << 16, "df_keys": 1 << 10,
              "df_atol": 1e-4, "reduce_rtol": 1e-5,
              "arch": "tinyllama-1.1b", "smoke": True, "grad_b": 2,
              "grad_s": 64, "ef_syncs": 8, "pipe_micro": 8, "pipe_shape": [2, 16, 64]}


@pytest.fixture(scope="module")
def card_ranks(tmp_path_factory):
    _card()
    import torch_dist_ranks as DR
    return DR.launch("card", 2, tmp_path_factory.mktemp("ranks"), spec=CARD2_SPEC,
                     timeout=600)


@pytest.mark.cuda
def test_int8_all_reduce_across_two_ranks_on_the_card(card_ranks):
    """The smoke gradient tree synced with compressed_grad_sync between two
    ranks on the card: within 0.02 of the fp32 all-reduce mean, bitwise
    the same on both ranks, error feedback no worse than 1.05x plain; the
    all-reduces took the card's tensors on gloo."""
    for res in card_ranks:
        g = res["grads"]
        assert g["max_rel_err"] < 0.02 and g["ef_err"] <= 1.05 * g["plain_err"]
        assert res["wire"]["all_reduce"] == [{"backend": "gloo", "world": 2,
                                              "device": "cuda:0"}]
    assert card_ranks[0]["grads"]["checksums"] == card_ranks[1]["grads"]["checksums"]


@pytest.mark.cuda
def test_dataframe_exchange_across_two_ranks_on_the_card(card_ranks):
    """Each rank's shard of shuffle, sort, join, groupby_sum and reduce_sum
    on the process mesh equals the 2-shard logical mesh's, kernel 7
    counted in the ranks (shuffle 1, join 2, groupby 1); the buckets
    crossed as card tensors (all_to_all_single on gloo); GPipe's messages
    through host copies."""
    want = {"shuffle": 1, "sort": 0, "join": 2, "groupby": 1, "reduce": 0}
    for res in card_ranks:
        assert {n: row["equal"] for n, row in res["dataframe"].items()} == \
            {n: True for n in want}
        assert {n: row["hash_launches"] for n, row in res["dataframe"].items()} == want
        assert res["wire"]["all_to_all_single"] == [{"backend": "gloo", "world": 2,
                                                     "device": "cuda:0"}]
        assert res["pipeline"]["max_rel_diff"] <= 1e-5
    assert card_ranks[0]["wire"]["send"] == [{"backend": "gloo", "world": 2, "device": "cpu"}]
