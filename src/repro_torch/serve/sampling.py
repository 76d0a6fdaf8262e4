"""Per-slot token sampling for the ServeEngine (mirror of
``repro.serve.sampling``).

One function covers every slot of the fused decode batch: temperature and
top-k are per-row vectors, and randomness comes from per-slot threefry
keys that the engine threads through checkpoint and restore, so a
preempted and resumed engine replays exactly the stream an uninterrupted
one would have produced.  The keys, the split and the random bits are
JAX's bit for bit: threefry2x32 with the partitionable ``split`` and
``random_bits`` of ``jax.random`` (``common/prng.py``), and the
uniform->gumbel conversion of ``jax.random.gumbel``'s default ``"low"``
mode.

Greedy (``temperature <= 0``, the default) takes the argmax of the raw
logits, bit-identical to the sampler-free path whatever the other slots
of the batch do.
"""
from __future__ import annotations

import numpy as np
import torch

# threefry's draws live in common/prng.py; the sampler's callers and
# tests reach split and random_bits here too
from repro_torch.common.prng import random_bits, split, uniform  # noqa: F401

_TINY = float(np.finfo(np.float32).tiny)


def make_slot_key(seed: int) -> np.ndarray:
    """Per-request threefry key (uint32[2]) from a request seed, the same
    (hi, lo) packing ``jax.random.PRNGKey`` produces."""
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                    np.uint32)


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel`` (float32, mode "low") of every row's key ->
    [B, n]: -log(-log(u)) of u uniform in [tiny, 1)."""
    return -torch.log(-torch.log(uniform(keys, n, _TINY, 1.0)))


def sample_tokens(logits: torch.Tensor,       # [B, V]
                  keys: torch.Tensor,         # [B, 2] int64 threefry words
                  temperature: torch.Tensor,  # [B] f32 (<= 0: greedy)
                  top_k: torch.Tensor):       # [B] int (0: no filter)
    """Returns (tokens [B] int32, advanced keys [B, 2] int64).

    Every row's key advances every call (whether or not it sampled), so a
    slot's stream depends only on its own seed and step count, never on
    which neighbours share the fused batch.  Top-k keeps every logit >=
    the k-th largest (ties may keep more than k)."""
    V = logits.shape[-1]
    lf = logits.float()
    greedy = torch.argmax(lf, dim=-1).to(torch.int32)
    pairs = split(keys, 2)
    carry, use = pairs[:, 0], pairs[:, 1]
    scaled = lf / temperature.float().clamp(min=1e-6)[:, None]
    kth = torch.sort(lf, dim=-1, descending=True).values.gather(
        -1, (top_k.to(torch.int64) - 1).clamp(0, V - 1)[:, None])
    keep = torch.where((top_k > 0)[:, None], lf >= kth, True)
    masked = torch.where(keep, scaled, -torch.inf)
    sampled = torch.argmax(masked + gumbel(use, V), dim=-1).to(torch.int32)
    return torch.where(temperature > 0, sampled, greedy), carry
