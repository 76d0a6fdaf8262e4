"""The arithmetic of the bf16 tensor-core attention kernels
(``csrc/attn_tc.cuh``), emulated in torch on the CPU, against the plain
versions the card holds them to.

The kernels take bf16 Q, K, V; compute the scores Q K^T in fp32; walk the
keys in 64-key tiles with an online softmax in fp32; round the
probabilities P to bf16 for P V (fp32 accumulate) while the row sums l
come from the unrounded P; and round the output to bf16.  The rounding of
P is the one step the plain versions do not take.  The card holds the
kernels to the plain versions at 2e-2 max abs error on the bf16 outputs,
and the last rounding alone may put the two one bf16 ulp apart (2^-6 =
0.0156 at |x| in [2, 4)).  So the emulation is held to the plain version
before that rounding (the plain version on the same bf16 values in fp32)
within half of 2e-2, EMU_TOL: the step P takes moves the output by less
than that, and the card's check keeps its headroom.  The rounded outputs
are held to the card's own tolerance.  Run with ``-s`` to print the
errors.

The contiguous decode (``csrc/decode_tc.cuh``) takes the same steps at
another tiling: 16-key tiles dealt round-robin to the four warps of a
block, each warp with its own online softmax in base 2 (``exp2(s *
scale * log2e - m * scale * log2e)``), the warps' ``(m, l, O)`` merged
in the block, and rows longer than 512 positions split into blocks whose
fp32 partials a combine pass merges in natural exponents.  The paged
decode (``csrc/decode_attention_paged.cu``) runs the same routine on K/V
gathered through the clamped block table, its blocks spanning whole
pages (``paged_plan``)."""
import math

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.decode_attention import paged_plan  # noqa: E402
from repro_torch.kernels.prefill_attention import write_chunk, write_chunk_paged  # noqa: E402

TILE = 64     # keys per K/V tile, as the kernels walk them
DEC_TILE, DEC_WARPS, DEC_SPLIT = 16, 4, 512  # the contiguous decode's tiling
LOG2E = 1.0 / math.log(2.0)
EMU_TOL = 1e-2    # fp32, before the output's rounding: half the card's 2e-2
CARD_TOL = 2e-2   # bf16 outputs, as the card holds the kernels


def _bf16(rng, shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)


def tc_attend(q, k, v, visible):
    """q [R, D], k, v [S, D] bf16 (R rows sharing one K/V head); visible
    [R, S] bool -> [R, D] fp32, in the kernels' order of operations up to
    the output's rounding to bf16."""
    R, D = q.shape
    scale = 1.0 / math.sqrt(D)
    m = torch.full((R, 1), ref.NEG_INF)
    l = torch.zeros((R, 1))
    o = torch.zeros((R, D))
    for k0 in range(0, k.shape[0], TILE):
        s = (q.float() @ k[k0:k0 + TILE].float().T) * scale
        s = torch.where(visible[:, k0:k0 + TILE], s, ref.NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(dim=1, keepdim=True)          # unrounded P
        pv = p.to(torch.bfloat16).float() @ v[k0:k0 + TILE].float()
        o = o * alpha + pv                                  # bf16 P, fp32 sum
        m = m_new
    return o / l.clamp(min=1e-30)


def flash_emulated(q, k, v, causal):
    """q [B,H,S,D], k, v [B,KV,S,D] bf16 -> [B,H,S,D] fp32."""
    B, H, S, D = q.shape
    G = H // k.shape[1]
    pos = torch.arange(S)
    visible = pos[None, :] <= pos[:, None] if causal else torch.ones(S, S, dtype=torch.bool)
    out = torch.empty(q.shape)
    for b in range(B):
        for h in range(H):
            out[b, h] = tc_attend(q[b, h], k[b, h // G], v[b, h // G], visible)
    return out


def chunk_emulated(q, kc, vc, base, clens):
    """Both prefills' attention over contiguous caches [B, S, KV, D]: each
    (row, KV head)'s G*T flattened query rows attend causally; fp32 out,
    padding rows zero."""
    B, T, H, D = q.shape
    KV = kc.shape[2]
    G = H // KV
    kpos = torch.arange(kc.shape[1])
    out = torch.zeros(q.shape)
    for b in range(B):
        qpos = int(base[b]) + torch.arange(T)
        visible = (kpos[None, :] <= qpos[:, None]).repeat_interleave(G, dim=0)
        for kv in range(KV):
            rows = q[b, :, kv * G:(kv + 1) * G].reshape(T * G, D)  # r = t*G + g
            o = tc_attend(rows, kc[b, :, kv], vc[b, :, kv], visible)
            out[b, :, kv * G:(kv + 1) * G] = o.reshape(T, G, D)
    pad = torch.arange(T)[None, :] >= clens[:, None]
    out[pad] = 0
    return out


def paged_emulated(q, k_new, v_new, k_pages, v_pages, block_table, base, clens):
    """The paged prefill: the plain scatter, then the attention over the
    gathered pages."""
    write_chunk_paged(k_pages, block_table, k_new, base, clens)
    write_chunk_paged(v_pages, block_table, v_new, base, clens)
    return chunk_emulated(q, ref._gather_pages(k_pages, block_table),
                          ref._gather_pages(v_pages, block_table), base, clens)


def _warp_walk(q, k, v, tiles, scale_log2):
    """One warp of the decode: q [G, D] bf16; its tiles' keys in turn, an
    online softmax in base 2 on raw scores -> (m raw, l, O) in fp32."""
    G, D = q.shape
    m = torch.full((G, 1), ref.NEG_INF)
    l = torch.zeros((G, 1))
    o = torch.zeros((G, D))
    for p0, p1 in tiles:
        s = q.float() @ k[p0:p1].float().T
        m_new = torch.maximum(m, s.amax(dim=1, keepdim=True))
        alpha = torch.exp2((m - m_new) * scale_log2)
        p = torch.exp2(s * scale_log2 - m_new * scale_log2)
        l = l * alpha + p.sum(dim=1, keepdim=True)          # unrounded P
        o = o * alpha + p.to(torch.bfloat16).float() @ v[p0:p1].float()
        m = m_new
    return m, l, o


def decode_emulated(q, k, v, lens, window=0, span=None):
    """The contiguous decode: q [B, H, D], caches [B, S, KV, D] bf16 ->
    [B, H, D] fp32 in the kernel's order of operations; ``span``: the
    positions a block walks (the contiguous body's by default)."""
    B, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    scale_log2 = scale * LOG2E
    span = span or min(-(-S // DEC_TILE) * DEC_TILE, DEC_SPLIT)
    nsplit = -(-S // span)
    out = torch.zeros((B, H, D))
    for b in range(B):
        n = int(lens[b])
        hi, lo = min(max(n, 0), S), max(n - window, 0) if window else 0
        for kv in range(KV):
            qg = q[b, kv * G:(kv + 1) * G]
            parts = []  # (m in natural units, l, acc) of each block
            for sp in range(nsplit):
                start, end = max(sp * span, lo), min((sp + 1) * span, hi)
                if start >= end:
                    parts.append((torch.full((G, 1), ref.NEG_INF), torch.zeros((G, 1)),
                                  torch.zeros((G, D))))
                    continue
                tiles = [(p0, min(p0 + DEC_TILE, end)) for p0 in range(start, end, DEC_TILE)]
                warps = [_warp_walk(qg, k[b, :, kv], v[b, :, kv], tiles[w::DEC_WARPS],
                                    scale_log2) for w in range(DEC_WARPS)]
                mx = torch.stack([w[0] for w in warps]).amax(dim=0)
                f = [torch.exp2((w[0] - mx) * scale_log2) for w in warps]
                parts.append((mx * scale, sum(w[1] * fw for w, fw in zip(warps, f)),
                              sum(w[2] * fw for w, fw in zip(warps, f))))
            if nsplit == 1:  # an empty row: acc 0 over 1e-30
                o = parts[0][2] / parts[0][1].clamp(min=1e-30)
            else:  # the combine pass, in natural exponents
                m_all = torch.stack([p[0] for p in parts]).amax(dim=0)
                w = [torch.exp(p[0] - m_all) for p in parts]
                o = (sum(p[2] * wi for p, wi in zip(parts, w))
                     / sum(p[1] * wi for p, wi in zip(parts, w)).clamp(min=1e-30))
            out[b, kv * G:(kv + 1) * G] = o
    return out


def _check(label, got, want32, want):
    """got: the emulation in fp32; want32: the plain version in fp32 on
    the same bf16 values; want: the plain version in bf16."""
    err32 = (got - want32).abs().max().item()
    err16 = (got.to(torch.bfloat16).float() - want.float()).abs().max().item()
    print(f"{label}: max abs err {err32:.3g} before the output's rounding, "
          f"{err16:.3g} in bf16")
    assert err32 <= EMU_TOL and err16 <= CARD_TOL


@pytest.mark.parametrize("B,H,KV,S,D,causal", [
    (2, 8, 2, 100, 64, True),     # GQA 4, a ragged last tile
    (1, 4, 4, 65, 32, True),      # MHA, one key past a tile
    (2, 32, 4, 130, 64, True),    # tinyllama's heads
    (1, 8, 2, 128, 128, False),   # full attention, D 128
    (1, 4, 1, 2048, 64, True),    # a long causal walk: 32 tiles
])
def test_flash_emulation_within_half_the_card_tolerance(B, H, KV, S, D, causal):
    rng = np.random.default_rng(S + D)
    q, k, v = _bf16(rng, (B, H, S, D)), _bf16(rng, (B, KV, S, D)), _bf16(rng, (B, KV, S, D))
    got = flash_emulated(q, k, v, causal)
    want32 = ref.flash_attention_ref(q.float(), k.float(), v.float(), causal=causal)
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    _check(f"flash B{B} H{H} KV{KV} S{S} D{D} causal={causal}", got, want32, want)


@pytest.mark.parametrize("T,H,KV,D,base,clens", [
    (64, 32, 4, 64, [64, 0, 5], [64, 0, 37]),   # the serving shape, an inert row
    (17, 8, 2, 16, [0, 100], [17, 9]),          # smoke widths, a straddling chunk
])
def test_paged_prefill_emulation_within_half_the_card_tolerance(T, H, KV, D, base, clens):
    rng = np.random.default_rng(T + D)
    B, page, max_pages = len(base), 16, 16
    num_pages = B * max_pages + 1
    bt = torch.from_numpy(rng.permutation(num_pages)[:B * max_pages]
                          .reshape(B, max_pages).astype(np.int32))
    q, kn, vn = (_bf16(rng, s) for s in ((B, T, H, D), (B, T, KV, D), (B, T, KV, D)))
    kp, vp = _bf16(rng, (num_pages, page, KV, D)), _bf16(rng, (num_pages, page, KV, D))
    base, clens = torch.tensor(base, dtype=torch.int32), torch.tensor(clens, dtype=torch.int32)
    got = paged_emulated(q, kn, vn, kp.clone(), vp.clone(), bt, base, clens)
    want32, _, _ = ref.prefill_attention_paged_ref(
        *(t.float() for t in (q, kn, vn, kp, vp)), bt, base, clens)
    want, _, _ = ref.prefill_attention_paged_ref(q, kn, vn, kp.clone(), vp.clone(), bt,
                                                 base, clens)
    _check(f"paged prefill T{T} H{H} KV{KV} D{D}", got, want32, want)


@pytest.mark.parametrize("T,H,KV,D,S,base,clens", [
    (64, 32, 4, 64, 512, [64, 0, 480], [64, 0, 64]),   # serving shape; a chunk past S
    (33, 32, 32, 96, 256, [0, 100, 7], [33, 9, 0]),    # phi3-mini's MHA at D 96
    (17, 16, 2, 96, 128, [0, 100], [17, 9]),           # D 96, GQA 8
])
def test_contiguous_prefill_emulation_within_half_the_card_tolerance(T, H, KV, D, S, base,
                                                                     clens):
    rng = np.random.default_rng(T + D + S)
    B = len(base)
    q, kn, vn = (_bf16(rng, s) for s in ((B, T, H, D), (B, T, KV, D), (B, T, KV, D)))
    kc, vc = _bf16(rng, (B, S, KV, D)), _bf16(rng, (B, S, KV, D))
    base, clens = torch.tensor(base, dtype=torch.int32), torch.tensor(clens, dtype=torch.int32)
    k2, v2 = write_chunk(kc.clone(), kn, base, clens), write_chunk(vc.clone(), vn, base, clens)
    got = chunk_emulated(q, k2, v2, base, clens)
    want32, _, _ = ref.prefill_attention_ref(*(t.float() for t in (q, kn, vn, kc, vc)),
                                             base, clens)
    want, _, _ = ref.prefill_attention_ref(q, kn, vn, kc.clone(), vc.clone(), base, clens)
    _check(f"contiguous prefill T{T} H{H} KV{KV} D{D}", got, want32, want)


# lengths across the 16-key tile, the four warps' first round (64) and
# the 512-position split, an empty row and one past S
DEC_LENS = [0, 1, 15, 16, 17, 63, 64, 65, 200, 511, 512, 513, 1030, 1200]


@pytest.mark.parametrize("G", [1, 8])
@pytest.mark.parametrize("D", [64, 96])
@pytest.mark.parametrize("S,window", [(512, 0), (1100, 0), (1100, 100)])
def test_decode_emulation_within_half_the_card_tolerance(G, D, S, window):
    """S 512: one block a row, the warps merged in the block; S 1100: three
    blocks a row and the combine pass; a window of 100 across a split
    edge.  Rows with nothing live are exact zeros."""
    rng = np.random.default_rng(G + D + S + window)
    KV = 2
    lens = torch.tensor(DEC_LENS, dtype=torch.int32)
    B = len(DEC_LENS)
    q, k, v = _bf16(rng, (B, KV * G, D)), _bf16(rng, (B, S, KV, D)), _bf16(rng, (B, S, KV, D))
    got = decode_emulated(q, k, v, lens, window)
    want32 = ref.decode_attention_ref(q.float(), k.float(), v.float(), lens, window=window)
    want = ref.decode_attention_ref(q, k, v, lens, window=window)
    assert (got[0] == 0).all()
    _check(f"decode G{G} D{D} S{S} window {window}", got, want32, want)


@pytest.mark.parametrize("page", [8, 16])
@pytest.mark.parametrize("G", [1, 8])
@pytest.mark.parametrize("D", [64, 96])
@pytest.mark.parametrize("S,window", [(512, 0), (1104, 0), (1104, 100)])
def test_paged_decode_emulation_within_half_the_card_tolerance(page, G, D, S, window):
    """The paged decode: K/V gathered through a permuted block table whose
    entries past each row's pages are sentinels (clamped before the
    gather, as the kernel clamps them), blocks of whole pages as
    ``paged_plan`` cuts them: one a row at S 512, three and the combine
    pass at S 1104.  Rows with nothing live are exact zeros."""
    rng = np.random.default_rng(page + G + D + S + window)
    KV, max_pages = 2, S // page
    lens = torch.tensor(DEC_LENS, dtype=torch.int32)
    B = len(DEC_LENS)
    num_pages = B * max_pages + 3
    bt = rng.permutation(num_pages)[:B * max_pages].reshape(B, max_pages).astype(np.int32)
    for b, n in enumerate(DEC_LENS):
        bt[b, -(-n // page):] = num_pages + b  # sentinels past each row's pages
    bt = torch.from_numpy(bt)
    q = _bf16(rng, (B, KV * G, D))
    kp, vp = _bf16(rng, (num_pages, page, KV, D)), _bf16(rng, (num_pages, page, KV, D))
    tc, span, nsplit = paged_plan(torch.bfloat16, True, B, KV, max_pages, page)
    assert tc and nsplit == -(-S // 512)
    got = decode_emulated(q, ref._gather_pages(kp, bt), ref._gather_pages(vp, bt), lens,
                          window, span * page)
    want32 = ref.decode_attention_paged_ref(q.float(), kp.float(), vp.float(), bt, lens,
                                            window=window)
    want = ref.decode_attention_paged_ref(q, kp, vp, bt, lens, window=window)
    assert (got[0] == 0).all()
    _check(f"paged decode page {page} G{G} D{D} S{S} window {window}", got, want32, want)
