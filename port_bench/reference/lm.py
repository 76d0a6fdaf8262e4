"""Plain float32 reference of the served language models: the dense GQA
decoder (phi3-mini) and the GQA decoder whose channel block is a mixture
of experts beside a dense residual MLP (arctic), written from their
published description in plain torch.  It imports nothing of the
program.

Each layer: ``y = x + attn(rmsnorm(x))`` with rotate-half RoPE on q and
k and causal softmax attention (query heads grouped over the KV heads),
then either ``y + mlp(rmsnorm(y))`` (SwiGLU: ``(silu(h w1) * (h w3))
w2``) or, as HF's ``ArcticDecoderLayer`` computes it with
``parallel_attn_mlp_res``, ``y + mlp_res(rmsnorm_res(y)) +
moe(rmsnorm_post(x))``: the dense residual MLP reads the post-attention
stream and the experts read the layer's input.  The experts are routed as GShard routes them: softmax over the router's
logits, the top k (a tie to the lower index), gates renormalised over
the k, and at most ``C = max(ceil(n k cf / E), min_capacity)`` tokens an
expert in a routing group of ``n`` tokens, choices claimed first by rank
(every token's first choice before any second) and then in token order;
a choice past ``C`` is dropped.  Routing groups are what the engine ran:
each prompt chunk of a sequence with the chunk's padding (token 0, whose
attention output is zero) and each decoded token alone.

Weights are read from the tree the benchmark made (the program's
layout: a unit's layers stacked on a leading dim; query heads padded to
a multiple, group-major, the padded heads zero and skipped here; the
channel block's ``norm`` is Arctic's ``post_attention_layernorm`` and
``dense.norm`` its ``residual_layernorm``).  With
``fp8=True`` every linear layer but the router takes its input and its
weight through float8 e4m3 (a scale a row of the input and a column of
the weight): the lower-precision control.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

F8_MAX = 448.0


@dataclasses.dataclass
class Seq:
    tokens: List[int]                  # prompt + served tokens but the last
    prompt_len: int
    # prompt chunks as the engine ran them: (offset, tokens, chunk width T)
    chunks: Optional[List[Tuple[int, int, int]]] = None


def _f8(x: torch.Tensor, dim: int) -> torch.Tensor:
    s = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / F8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


class Ref:
    def __init__(self, W: Dict, m: Dict, fp8: bool = False):
        for flag in ("allow_tf32",):
            setattr(torch.backends.cuda.matmul, flag, False)
            setattr(torch.backends.cudnn, flag, False)
        self.W, self.m, self.fp8 = W, m, fp8
        self.margins: Dict = {}
        self.unit = W["unit"]["b0"]
        wq = self.unit["t"]["wq"]
        self.Hp = wq.shape[-2]
        self.H, self.KV, self.D = m["num_heads"], m["num_kv_heads"], m["head_dim"]
        gp, gl = self.Hp // self.KV, self.H // self.KV
        self.live = torch.tensor([g * gp + j for g in range(self.KV) for j in range(gl)],
                                 device=wq.device)

    # -- pieces ---------------------------------------------------------------

    def lin(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        w = w.float()
        if self.fp8:
            return _f8(x, -1) @ _f8(w, 0)
        return x @ w

    def rms(self, x, scale):
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + self.m["norm_eps"]) * scale.float()

    def rope(self, x, pos):
        d = x.shape[-1]
        inv = 1.0 / (self.m["rope_theta"] ** (torch.arange(0, d, 2, device=x.device,
                                                             dtype=torch.float32) / d))
        ang = pos[:, None].float() * inv
        cos, sin = ang.cos()[:, None], ang.sin()[:, None]
        x1, x2 = x.chunk(2, -1)
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)

    def attn(self, l: int, x: torch.Tensor) -> torch.Tensor:
        t, H, KV, D = self.unit["t"], self.H, self.KV, self.D
        S, d = x.shape
        h = self.rms(x, t["norm"]["scale"][l])
        wq = t["wq"][l][:, self.live].reshape(d, H * D)
        q = self.lin(h, wq).view(S, H, D)
        k = self.lin(h, t["wk"][l].reshape(d, KV * D)).view(S, KV, D)
        v = self.lin(h, t["wv"][l].reshape(d, KV * D)).view(S, KV, D)
        pos = torch.arange(S, device=x.device)
        q, k = self.rope(q, pos), self.rope(k, pos)
        G = H // KV
        k, v = k.repeat_interleave(G, 1), v.repeat_interleave(G, 1)
        o = torch.empty_like(q)
        for a in range(0, S, 256):
            b = min(S, a + 256)
            s = torch.einsum("qhd,khd->hqk", q[a:b], k[:b]) / math.sqrt(D)
            mask = torch.arange(b, device=x.device)[None, :] <= torch.arange(a, b, device=x.device)[:, None]
            p = torch.softmax(s.masked_fill(~mask, float("-inf")), -1)
            o[a:b] = torch.einsum("hqk,khd->qhd", p, v[:b])
        wo = t["wo"][l][self.live].reshape(H * D, d)
        return self.lin(o.reshape(S, H * D), wo)

    def mlp(self, p: Dict, l: int, x: torch.Tensor) -> torch.Tensor:
        h = self.rms(x, p["norm"]["scale"][l])
        return self.lin(F.silu(self.lin(h, p["w1"][l])) * self.lin(h, p["w3"][l]), p["w2"][l])

    def capacity(self, n: int) -> int:
        m = self.m
        return max(int(math.ceil(n * m["top_k"] * m["capacity_factor"] / m["num_experts"])),
                   m["min_capacity"])

    def moe(self, l: int, groups: List[torch.Tensor], keys=None) -> List[torch.Tensor]:
        """The experts' part of every routing group's tokens (``groups``:
        each ``[n, d]``).  For a group of one token with a key, the margin
        between its last chosen expert's probability and the next one's
        is kept (the least over the layers) in ``self.margins[key]``."""
        c, m = self.unit["c"], self.m
        E, K = m["num_experts"], m["top_k"]
        rows, outs = [], []
        hs = [self.rms(g, c["norm"]["scale"][l]) for g in groups]
        h_all = torch.cat(hs)
        assign_row, assign_e, assign_gate = [], [], []
        base = 0
        for gi, h in enumerate(hs):
            n = h.shape[0]
            probs = torch.softmax(h @ c["router"][l].float(), -1)
            vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
            if keys is not None and keys[gi] is not None and n == 1:
                gap = float(vals[0, K - 1] - vals[0, K])
                self.margins[keys[gi]] = min(gap, self.margins.get(keys[gi], gap))
            gates, idx = vals[:, :K], idx[:, :K]
            gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
            flat = idx.t().reshape(-1)                         # rank-major, then token
            oh = F.one_hot(flat, E)
            pos = ((oh.cumsum(0) - 1) * oh).sum(-1)
            keep = (pos < self.capacity(n)) & (gates.t().reshape(-1) > 0)
            tok = torch.arange(n, device=h.device).repeat(K) + base
            assign_row.append(tok[keep])
            assign_e.append(flat[keep])
            assign_gate.append(gates.t().reshape(-1)[keep])
            base += n
        r, e, g = torch.cat(assign_row), torch.cat(assign_e), torch.cat(assign_gate)
        y = torch.zeros_like(h_all)
        for ex in torch.unique(e).tolist():
            sel = e == ex
            hx = h_all[r[sel]]
            u = F.silu(self.lin(hx, c["w1"][l, ex])) * self.lin(hx, c["w3"][l, ex])
            y.index_add_(0, r[sel], self.lin(u, c["w2"][l, ex]) * g[sel, None])
        sizes = [h.shape[0] for h in hs]
        return list(y.split(sizes))

    def moe_reads(self, layer_in: List[torch.Tensor], post_attn: List[torch.Tensor]):
        """The stream the experts route and compute on: the layer's input
        (``post_attention_layernorm(residual_input)`` in HF's Arctic)."""
        return layer_in

    # -- the forward ------------------------------------------------------------

    @torch.no_grad()
    def served_logits(self, seqs: Sequence[Seq]) -> List[torch.Tensor]:
        """Each sequence's logits ``[len(tokens) - prompt_len + 1, V]`` at
        the positions that chose its served tokens."""
        W, m = self.W, self.m
        dev = W["embed"].device
        xs = [W["embed"][torch.as_tensor(s.tokens, device=dev)].float() for s in seqs]
        moe = bool(m.get("num_experts"))
        pads: List[List[torch.Tensor]] = []
        if moe:
            pads = [[W["embed"][0].float().expand(T - take, -1).clone()
                     for (_, take, T) in s.chunks] for s in seqs]
        for l in range(m["num_layers"]):
            posts = [x + self.attn(l, x) for x in xs]
            if not moe:
                xs = [y + self.mlp(self.unit["c"], l, y) for y in posts]
                continue
            # a padded row's attention output is zero: its stream is the same
            # before and after attention
            routed = self.moe_reads(xs, posts)
            groups, post_groups, where = [], [], []
            for i, s in enumerate(seqs):
                for j, (off, take, T) in enumerate(s.chunks):
                    groups.append(torch.cat([routed[i][off:off + take], pads[i][j]]))
                    post_groups.append(torch.cat([posts[i][off:off + take], pads[i][j]]))
                    where.append((i, j, off, take))
                for p in range(s.prompt_len, len(s.tokens)):
                    groups.append(routed[i][p:p + 1])
                    post_groups.append(posts[i][p:p + 1])
                    where.append((i, None, p, 1))
            ys = self.moe(l, groups, [(i, off) if j is None else None
                                      for i, j, off, _ in where])
            dense = self.mlp(self.unit["c"]["dense"], l, torch.cat(post_groups))
            dense = dense.split([g.shape[0] for g in post_groups])
            new = [y.clone() for y in posts]
            for g, y, z, (i, j, off, take) in zip(post_groups, ys, dense, where):
                out = g + y + z
                new[i][off:off + take] = out[:take]
                if j is not None:
                    pads[i][j] = out[take:]
            xs = new
        out = []
        for x, s in zip(xs, seqs):
            h = self.rms(x[s.prompt_len - 1:], W["final_norm"]["scale"])
            out.append(self.lin(h, W["lm_head"])[:, :m["vocab_size"]])
        return out


def gaps(ref_logits: torch.Tensor, tokens: Sequence[int]) -> torch.Tensor:
    """By how much each token's logit lies below the row's best."""
    t = torch.as_tensor(list(tokens), device=ref_logits.device)
    return ref_logits.max(-1).values - ref_logits.gather(1, t[:, None])[:, 0]
