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
errors."""
import math

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.prefill_attention import write_chunk_paged  # noqa: E402

TILE = 64     # keys per K/V tile, as the kernels walk them
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


def paged_emulated(q, k_new, v_new, k_pages, v_pages, block_table, base, clens):
    """The paged prefill: the plain scatter, then each (row, KV head)'s
    G*T flattened query rows attend its gathered pages; fp32 out."""
    write_chunk_paged(k_pages, block_table, k_new, base, clens)
    write_chunk_paged(v_pages, block_table, v_new, base, clens)
    B, T, H, D = q.shape
    KV = k_pages.shape[2]
    G = H // KV
    kc, vc = ref._gather_pages(k_pages, block_table), ref._gather_pages(v_pages, block_table)
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
