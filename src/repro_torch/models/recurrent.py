"""Recurrent temporal mixers (mirror of ``repro.models.recurrent``): the
RG-LRU of RecurrentGemma/Griffin, and the mLSTM and sLSTM of xLSTM.

Sequence forms, as in JAX:
* RG-LRU: an elementwise linear recurrence, scanned in chunks of 2048
  (the boundary state carried between them) with a log-depth scan inside
  each chunk;
* mLSTM: the chunked parallel form (the matrix memory carried across
  chunks of 256, quadratic only inside a chunk);
* sLSTM: strictly sequential (recurrent weights), a loop over time.

Each block also has a one-token decode path over a small state.  The
JAX package has no Pallas kernel here, so neither has the port: these
are plain PyTorch.  The block functions take a cache dict and write the
new state into its tensors in place (the JAX blocks return new ones); a
cached call takes one token (S == 1), where JAX's cached step reads only
the first token of a longer input (ROADMAP.md queue 3).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.common.params import Param
from repro_torch.configs.base import ModelConfig
from repro_torch.models.blocks import block_out, rmsnorm_apply, rmsnorm_specs


def _check_step(kind: str, S: int) -> None:
    if S != 1:
        raise NotImplementedError(
            f"a cached {kind} block decodes one token at a time (S == 1), got "
            f"S={S}: the reference's cached step reads only the first token and "
            f"broadcasts its output (ROADMAP.md queue 3); run the no-cache "
            f"forward, or decode token by token")


def _chunks(S: int, chunk: int) -> int:
    """Chunks of ``chunk`` in ``S`` (JAX reshapes ``[B, S, ...]`` into
    ``[B, S // chunk, chunk, ...]``, which fails unless chunk divides S)."""
    nc = S // chunk
    if nc * chunk != S:
        raise TypeError(f"a chunked scan needs the chunk to divide the sequence: "
                        f"{S} positions in chunks of {chunk}")
    return nc


# ---------------------------------------------------------------------------
# causal depthwise conv1d (width w), used by griffin and the mLSTM
# ---------------------------------------------------------------------------


def conv1d_specs(width: int, channels: int) -> Dict[str, Param]:
    return {"w": Param((width, channels), (None, "rnn"), init="normal", scale=0.1)}


def conv1d_apply(params, x: torch.Tensor, state: Optional[torch.Tensor] = None):
    """x: [B,S,C]; state (decode): [B,w-1,C], the previous inputs.  Returns
    ``(y, new_state)``."""
    w = params["w"].shape[0]
    if state is None:
        pad = F.pad(x, (0, 0, w - 1, 0))
    else:
        pad = torch.cat([state.to(x.dtype), x], dim=1)
    new_state = pad[:, -(w - 1):, :] if w > 1 else None
    L = pad.shape[1]
    y = sum(pad[:, i:L - (w - 1 - i), :] * params["w"][i].to(x.dtype) for i in range(w))
    return y, new_state


# ---------------------------------------------------------------------------
# RG-LRU (Griffin eq. 3-4): a per-channel gated linear recurrence
# ---------------------------------------------------------------------------

_C_RGLRU = 8.0


def rglru_specs(cfg: ModelConfig) -> Dict[str, Any]:
    d, r = cfg.d_model, cfg.rnn_width
    return {
        "norm": rmsnorm_specs(d),
        "wx": Param((d, r), ("embed", "rnn")),
        "wgate": Param((d, r), ("embed", "rnn")),
        "conv": conv1d_specs(cfg.conv_width, r),
        "lam": Param((r,), ("rnn",), init="normal", scale=1.0),  # Λ
        "wa": Param((r,), ("rnn",), init="normal", scale=0.1),   # recurrence gate
        "ba": Param((r,), ("rnn",), init="zeros"),
        "wi": Param((r,), ("rnn",), init="normal", scale=0.1),   # input gate
        "bi": Param((r,), ("rnn",), init="zeros"),
        "wo": Param((r, d), ("rnn", "embed")),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)`` at every x
    (``F.softplus`` returns x itself above its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _rglru_coeffs(params, u: torch.Tensor):
    """u: [...,r], the branch input -> (a, gated input), fp32."""
    uf = u.float()
    r_gate = torch.sigmoid(uf * params["wa"].float() + params["ba"].float())
    i_gate = torch.sigmoid(uf * params["wi"].float() + params["bi"].float())
    log_a = -_C_RGLRU * r_gate * _softplus(params["lam"].float())
    a = torch.exp(log_a)
    scaled_in = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6)) * (i_gate * uf)
    return a, scaled_in


def _linear_scan(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan along dim 1 of the pairs (a, b) under JAX's combine
    ``(a1, b1), (a2, b2) -> (a1 a2, a2 b1 + b2)``, in log2(n) doubling
    steps: returns (the running products of a, h with h_t = a_t h_{t-1} +
    b_t from h_{-1} = 0)."""
    n, off = a.shape[1], 1
    while off < n:
        a, b = (torch.cat([a[:, :off], a[:, :-off] * a[:, off:]], dim=1),
                torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]], dim=1))
        off *= 2
    return a, b


def rglru_scan(params, u: torch.Tensor, chunk: int = 2048) -> torch.Tensor:
    """u: [B,S,r] -> h: [B,S,r] in u's dtype.

    Chunked as in JAX: a loop over S/chunk blocks carrying the boundary
    state, a log-depth scan inside each block, which bounds the scan's
    intermediates to O(chunk).  A sequence of less than two chunks is
    scanned whole; otherwise the chunk must divide S."""
    a, b = _rglru_coeffs(params, u)
    B, S, r = a.shape
    chunk = min(chunk, S)
    nc = S // chunk
    if nc <= 1:
        return _linear_scan(a, b)[1].to(u.dtype)
    _chunks(S, chunk)
    h_last = torch.zeros((B, r), dtype=torch.float32, device=u.device)
    hs = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        a_cum, b_cum = _linear_scan(a[:, sl], b[:, sl])
        h = a_cum * h_last[:, None, :] + b_cum
        hs.append(h)
        h_last = h[:, -1, :]
    return torch.cat(hs, dim=1).to(u.dtype)


def rglru_step(params, u: torch.Tensor, h_prev: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """u: [B,1,r]; h_prev: [B,r] -> (output [B,1,r] in u's dtype, h fp32)."""
    a, b = _rglru_coeffs(params, u[:, 0])
    h = a * h_prev.float() + b
    return h.to(u.dtype)[:, None], h


def rglru_block_apply(cfg: ModelConfig, params, x: torch.Tensor,
                      cache: Optional[Dict] = None) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Griffin's recurrent block: the gate branch times the (conv -> RG-LRU)
    branch.  ``cache`` {"conv" [B,w-1,r], "h" [B,r]} is written in place."""
    cdt = cfg.compute_dtype
    h = rmsnorm_apply(params["norm"], x, cfg.norm_eps).to(cdt)
    gate = F.gelu(h @ params["wgate"].to(cdt), approximate="tanh")
    u = h @ params["wx"].to(cdt)
    new_cache = None
    if cache is None:
        u, _ = conv1d_apply(params["conv"], u)
        r = rglru_scan(params, u)
    else:
        _check_step("rglru", x.shape[1])
        u, conv_state = conv1d_apply(params["conv"], u, cache["conv"])
        r, h_state = rglru_step(params, u, cache["h"])
        cache["conv"].copy_(conv_state)
        cache["h"].copy_(h_state)
        new_cache = {"conv": cache["conv"], "h": cache["h"]}
    y = block_out(torch.matmul, r * gate, params["wo"].to(cdt))
    return x + y.to(x.dtype), new_cache


# ---------------------------------------------------------------------------
# mLSTM (xLSTM): a matrix memory, chunked parallel over the sequence
# ---------------------------------------------------------------------------


def mlstm_specs(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    m = 2 * d  # the official projection factor 2
    nh = cfg.num_heads
    return {
        "norm": rmsnorm_specs(d),
        "wup": Param((d, 2 * m), ("embed", "rnn")),
        "conv": conv1d_specs(cfg.conv_width, m),
        "wq": Param((m, m), ("rnn", None)),
        "wk": Param((m, m), ("rnn", None)),
        "wv": Param((m, m), ("rnn", None)),
        "wi": Param((m, nh), ("rnn", None), init="normal", scale=0.02),
        "bi": Param((nh,), (None,), init="zeros"),
        "wf": Param((m, nh), ("rnn", None), init="normal", scale=0.02),
        "bf": Param((nh,), (None,), init="ones"),
        "gnorm": rmsnorm_specs(m // nh),
        "wdown": Param((m, d), ("rnn", "embed")),
    }


def _mlstm_chunk_scan(q, k, v, log_i, log_f, chunk: int) -> torch.Tensor:
    """The chunked-parallel mLSTM.  q, k, v: [B,S,nh,dh]; log_i, log_f:
    [B,S,nh] (fp32).  Returns h [B,S,nh,dh] in fp32."""
    B, S, nh, dh = q.shape
    nc = _chunks(S, chunk)
    scale = 1.0 / math.sqrt(dh)
    dev = q.device
    C_prev = torch.zeros((B, nh, dh, dh), dtype=torch.float32, device=dev)
    n_prev = torch.zeros((B, nh, dh), dtype=torch.float32, device=dev)
    m_prev = torch.full((B, nh), -1e30, dtype=torch.float32, device=dev)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=dev))
    hs = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        qb, kb, vb = q[:, sl].float(), k[:, sl].float(), v[:, sl].float()
        lib, lfb = log_i[:, sl], log_f[:, sl]
        fcum = torch.cumsum(lfb, dim=1)  # [B,c,nh]
        ftot = fcum[:, -1]
        # the decay inside the chunk: D[t,s] = exp(fcum_t - fcum_s + i_s), s <= t
        lD = fcum[:, :, None, :] - fcum[:, None, :, :] + lib[:, None, :, :]
        lD = torch.where(tri[None, :, :, None], lD, -math.inf)
        # the coefficient of the carried state at target t: exp(fcum_t)
        l_inter = fcum
        m_intra = lD.amax(dim=2)  # [B,c,nh]
        m_new = torch.maximum(m_intra, l_inter + m_prev[:, None, :])
        m_new = torch.clamp(m_new, min=-1e30)
        D = torch.exp(lD - m_new[:, :, None, :])  # [B,c,c,nh]
        inter_w = torch.exp(l_inter + m_prev[:, None, :] - m_new)  # [B,c,nh]

        s_qk = torch.einsum("bthd,bshd->btsh", qb, kb) * scale
        intra = torch.einsum("btsh,bshd->bthd", s_qk * D, vb)
        inter = torch.einsum("bthd,bhde->bthe", qb * scale, C_prev) * inter_w[..., None]
        num = intra + inter
        # the normaliser
        qn = torch.einsum("bthd,bhd->bth", qb * scale, n_prev) * inter_w
        denom = torch.abs((s_qk * D).sum(dim=2) + qn)
        hs.append(num / torch.maximum(denom, torch.exp(-m_new))[..., None])

        # the carry, decayed to the end of the chunk
        tail = lib + (ftot[:, None] - fcum)
        m_next = torch.maximum(ftot + m_prev, tail.amax(dim=1))
        w_old = torch.exp(ftot + m_prev - m_next)  # [B,nh]
        w_k = torch.exp(tail - m_next[:, None])  # [B,c,nh]
        C_prev = C_prev * w_old[..., None, None] + torch.einsum(
            "bsh,bshd,bshe->bhde", w_k, kb, vb)
        n_prev = n_prev * w_old[..., None] + torch.einsum("bsh,bshd->bhd", w_k, kb)
        m_prev = m_next
    return torch.cat(hs, dim=1)


def mlstm_step(q, k, v, log_i, log_f, state):
    """One decode step.  q, k, v: [B,1,nh,dh]; log_i, log_f: [B,1,nh];
    state = (C [B,nh,dh,dh], n [B,nh,dh], m [B,nh]).  Returns (h
    [B,1,nh,dh], the new state)."""
    C_prev, n_prev, m_prev = state
    dh = q.shape[-1]
    scale = 1.0 / math.sqrt(dh)
    li, lf = log_i[:, 0], log_f[:, 0]
    m_new = torch.maximum(lf + m_prev, li)
    f_w = torch.exp(lf + m_prev - m_new)
    i_w = torch.exp(li - m_new)
    kb = k[:, 0].float()
    vb = v[:, 0].float()
    C = C_prev * f_w[..., None, None] + i_w[..., None, None] * torch.einsum(
        "bhd,bhe->bhde", kb, vb)
    n = n_prev * f_w[..., None] + i_w[..., None] * kb
    qb = q[:, 0].float() * scale
    num = torch.einsum("bhd,bhde->bhe", qb, C)
    denom = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", qb, n)), torch.exp(-m_new))
    h = (num / denom[..., None])[:, None]
    return h, (C, n, m_new)


def mlstm_block_apply(cfg: ModelConfig, params, x: torch.Tensor,
                      cache: Optional[Dict] = None, chunk: int = 256
                      ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """xLSTM's mLSTM block.  ``cache`` {"conv" [B,w-1,m], "state" (C, n,
    m)} is written in place."""
    cdt = cfg.compute_dtype
    B, S, _ = x.shape
    nh = cfg.num_heads
    m = params["wq"].shape[0]
    dh = m // nh
    h = rmsnorm_apply(params["norm"], x, cfg.norm_eps).to(cdt)
    up = h @ params["wup"].to(cdt)
    u, z = up[..., :m], up[..., m:]
    if cache is None:
        uc, _ = conv1d_apply(params["conv"], u)
    else:
        _check_step("mlstm", S)
        uc, conv_state = conv1d_apply(params["conv"], u, cache["conv"])
    uact = F.silu(uc)
    q = (uact @ params["wq"].to(cdt)).reshape(B, S, nh, dh)
    k = (uact @ params["wk"].to(cdt)).reshape(B, S, nh, dh)
    v = (u @ params["wv"].to(cdt)).reshape(B, S, nh, dh)
    log_i = (uact @ params["wi"].to(cdt) + params["bi"].to(cdt)).float()
    log_f = F.logsigmoid((uact @ params["wf"].to(cdt) + params["bf"].to(cdt)).float())
    new_cache = None
    if cache is None:
        hseq = _mlstm_chunk_scan(q, k, v, log_i, log_f, min(chunk, S))
    else:
        hseq, state = mlstm_step(q, k, v, log_i, log_f, cache["state"])
        cache["conv"].copy_(conv_state)
        for old, new in zip(cache["state"], state):
            old.copy_(new)
        new_cache = {"conv": cache["conv"], "state": cache["state"]}
    hseq = rmsnorm_apply(params["gnorm"], hseq.to(cdt), cfg.norm_eps)
    out = hseq.reshape(B, S, m) * F.silu(z)
    y = out @ params["wdown"].to(cdt)
    return x + y.to(x.dtype), new_cache


# ---------------------------------------------------------------------------
# sLSTM (xLSTM): a scalar memory with block-diagonal recurrent weights
# ---------------------------------------------------------------------------


def slstm_specs(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    nh = cfg.num_heads
    dh = d // nh
    ff = max(int(d * 4 / 3) // 64 * 64, 64)
    return {
        "norm": rmsnorm_specs(d),
        "wz": Param((d, d), ("embed", "rnn")),
        "wi": Param((d, d), ("embed", "rnn")),
        "wf": Param((d, d), ("embed", "rnn")),
        "wo": Param((d, d), ("embed", "rnn")),
        "rz": Param((nh, dh, dh), (None, None, None), init="normal", scale=0.05),
        "ri": Param((nh, dh, dh), (None, None, None), init="normal", scale=0.05),
        "rf": Param((nh, dh, dh), (None, None, None), init="normal", scale=0.05),
        "ro": Param((nh, dh, dh), (None, None, None), init="normal", scale=0.05),
        "gnorm": rmsnorm_specs(d),
        # the gated FFN (factor 4/3), part of the sLSTM block in xLSTM
        "ff_w1": Param((d, ff), ("embed", "mlp")),
        "ff_w3": Param((d, ff), ("embed", "mlp")),
        "ff_w2": Param((ff, d), ("mlp", "embed")),
    }


def _recurrent_weights(params) -> torch.Tensor:
    """The four gates' recurrent weights side by side, [nh, dh, 4 dh] fp32:
    one product a step gives every gate's ``h R`` (each element the same
    dot product as JAX's four)."""
    return torch.cat([params[w].float() for w in ("rz", "ri", "rf", "ro")], dim=-1)


def _to_heads(t: torch.Tensor, nh: int) -> torch.Tensor:
    """[B, d] -> the heads-major [nh, B, dh] the loop runs in."""
    return t.reshape(t.shape[0], nh, -1).transpose(0, 1)


def _from_heads(t: torch.Tensor) -> torch.Tensor:
    """[nh, B, dh] -> [B, d]."""
    return t.transpose(0, 1).reshape(t.shape[1], -1)


def _gate_inputs(xz, xi, xf, xo, nh: int) -> torch.Tensor:
    """The gates' input pre-activations [B, S, d] each -> [S, nh, B, 4 dh],
    gate-major in the last dim as ``_recurrent_weights``'s columns."""
    B, S, d = xz.shape
    x = torch.stack([xz, xi, xf, xo], dim=2).reshape(B, S, 4, nh, d // nh)
    return x.permute(1, 3, 0, 2, 4).reshape(S, nh, B, 4 * (d // nh))


def _slstm_step(r_all, x_t, state):
    """One timestep in the heads-major layout: x_t [nh, B, 4 dh], the
    gates' input pre-activations; state (c, n, h, m), each [nh, B, dh].
    JAX's cell, with every gate's pre-activation ``x + h R`` in one batched
    product and the products and sums fused where the order stays JAX's."""
    c, n, h, m = state
    pz, pi, pf, po = torch.baddbmm(x_t, h, r_all).split(h.shape[-1], dim=-1)
    z = torch.tanh(pz)
    o = torch.sigmoid(po)
    logf_m = F.logsigmoid(pf) + m
    m_new = torch.maximum(logf_m, pi)
    i_p = torch.exp(pi - m_new)
    f_p = torch.exp(logf_m - m_new)
    c_new = torch.addcmul(f_p * c, i_p, z)
    n_new = torch.clamp(torch.addcmul(i_p, f_p, n), min=1e-6)
    h_new = o * c_new / n_new
    return (c_new, n_new, h_new, m_new)


def _slstm_cell(params, xz, xi, xf, xo, state, nh, dh):
    """One timestep.  x*: [B,d] pre-activations from the input; state = (c,
    n, h, m), each [B,d]."""
    x_t = _gate_inputs(*(t[:, None] for t in (xz, xi, xf, xo)), nh)[0]
    out = _slstm_step(_recurrent_weights(params), x_t,
                      tuple(_to_heads(t, nh) for t in state))
    return tuple(_from_heads(t) for t in out)


def slstm_block_apply(cfg: ModelConfig, params, x: torch.Tensor,
                      cache: Optional[Dict] = None) -> Tuple[torch.Tensor, Optional[Dict]]:
    """xLSTM's sLSTM block and its gated FFN.  ``cache`` {"state" (c, n, h,
    m)} is written in place."""
    cdt = cfg.compute_dtype
    B, S, d = x.shape
    nh = cfg.num_heads
    dh = d // nh
    hin = rmsnorm_apply(params["norm"], x, cfg.norm_eps).to(cdt)
    xs = _gate_inputs(*((hin @ params[w].to(cdt)).float() for w in ("wz", "wi", "wf", "wo")),
                      nh)
    r_all = _recurrent_weights(params)
    if cache is None:
        zeros = torch.zeros((nh, B, dh), dtype=torch.float32, device=x.device)
        state = (zeros, zeros, zeros, torch.full_like(zeros, -1e30))
        hs = []
        for t in range(S):
            state = _slstm_step(r_all, xs[t], state)
            hs.append(state[2])
        hseq = torch.stack(hs).permute(2, 0, 1, 3).reshape(B, S, d)
        new_cache = None
    else:
        _check_step("slstm", S)
        state = _slstm_step(r_all, xs[0], tuple(_to_heads(t, nh) for t in cache["state"]))
        for old, new in zip(cache["state"], state):
            old.copy_(_from_heads(new))
        hseq = cache["state"][2][:, None]
        new_cache = {"state": cache["state"]}
    hseq = rmsnorm_apply(params["gnorm"], hseq.to(cdt), cfg.norm_eps)
    # the gated FFN
    u = hseq @ params["ff_w1"].to(cdt)
    g = hseq @ params["ff_w3"].to(cdt)
    y = (F.silu(u) * g) @ params["ff_w2"].to(cdt)
    return x + y.to(x.dtype), new_cache
