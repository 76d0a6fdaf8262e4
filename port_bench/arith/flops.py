"""Model FLOPs of served tokens, for ``mfu``: the work the tokens need,
whatever computes it.  Padding is not counted, nor the heads a layout
pads; a mixture of experts counts its router and its top-k experts only.

A token at position ``i`` (it attends ``i + 1`` positions) costs in each
layer ``2 * d * (H + 2 KV) * D`` for the Q, K and V projections, ``2 * H
* D * d`` for the output projection, ``4 * H * D * (i + 1)`` for the
scores and the weighted sum, and its channel block: ``6 * d * ff`` for a
SwiGLU MLP; ``2 * d * E + top_k * 6 * d * ff + 6 * d * dense_ff`` for a
mixture of experts with a dense residual MLP.  The output head, ``2 * d
* V``, is counted once for every token that is served (the logits that
choose it), not for the other prompt positions.
"""
from __future__ import annotations

from typing import Dict


def layer_flops_per_token(m: Dict) -> float:
    """FLOPs of one layer for one token, attention scores excluded."""
    d, H, KV, D = m["d_model"], m["num_heads"], m["num_kv_heads"], m["head_dim"]
    f = 2 * d * (H + 2 * KV) * D + 2 * H * D * d
    if m.get("num_experts"):
        f += 2 * d * m["num_experts"] + m["top_k"] * 6 * d * m["d_ff"]
        if m.get("dense_ff"):
            f += 6 * d * m["dense_ff"]
    else:
        f += 6 * d * m["d_ff"]
    return float(f)


def attention_flops(m: Dict, first_pos: int, n: int) -> float:
    """Scores and weighted sums of ``n`` tokens at positions ``first_pos``
    .. ``first_pos + n - 1``, over every layer."""
    H, D = m["num_heads"], m["head_dim"]
    # sum of (i + 1) for i in [first_pos, first_pos + n)
    s = n * first_pos + n * (n + 1) // 2
    return float(4 * H * D * s * m["num_layers"])


def tokens_flops(m: Dict, first_pos: int, n: int, served: int) -> float:
    """``n`` tokens processed at positions from ``first_pos``, of which
    ``served`` produce a served token."""
    return (n * m["num_layers"] * layer_flops_per_token(m)
            + attention_flops(m, first_pos, n)
            + served * 2.0 * m["d_model"] * m["vocab_size"])
