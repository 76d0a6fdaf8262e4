"""Per-slot token sampling for the ServeEngine (mirror of
``repro.serve.sampling``).

One function covers every slot of the fused decode batch: temperature and
top-k are per-row vectors, and randomness comes from per-slot threefry
keys that the engine threads through checkpoint and restore, so a
preempted and resumed engine replays exactly the stream an uninterrupted
one would have produced.  The keys, the split and the random bits are
JAX's bit for bit: threefry2x32 (20 rounds, Salmon et al. 2011) with the
partitionable ``split`` and ``random_bits`` of ``jax.random`` (a counter
of the element's flat index, split in its high and low 32 bits, hashed
under the key; bits = the two words xor-ed), and the uniform->gumbel
conversion of ``jax.random.gumbel``'s default ``"low"`` mode.  torch has
no unsigned 32-bit arithmetic on every device, so the words are int64
tensors in ``[0, 2^32)``, masked after every add and shift.

Greedy (``temperature <= 0``, the default) takes the argmax of the raw
logits, bit-identical to the sampler-free path whatever the other slots
of the batch do.
"""
from __future__ import annotations

import numpy as np
import torch

_MASK = 0xFFFFFFFF
# threefry2x32's rotations, alternating every four rounds, and the key
# schedule's parity constant
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_TINY = float(np.finfo(np.float32).tiny)


def make_slot_key(seed: int) -> np.ndarray:
    """Per-request threefry key (uint32[2]) from a request seed, the same
    (hi, lo) packing ``jax.random.PRNGKey`` produces."""
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                    np.uint32)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x1, x2):
    """The threefry2x32 hash of the counter words ``(x1, x2)`` under the
    key ``(k1, k2)``: int64 tensors of 32-bit words, broadcast together
    -> the two hashed words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x1, x2


def _hash_counts(keys: torch.Tensor, n: int):
    """Each row's key [B, 2] over the counter 0 .. n-1 -> the two hashed
    words [B, n]: the counter's high and low 32 bits are the two input
    words, as ``iota_2x32_shape`` builds them."""
    count = torch.arange(n, dtype=torch.int64, device=keys.device)[None, :]
    return threefry2x32(keys[:, :1], keys[:, 1:], count >> 32, count & _MASK)


def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` of every row's key: [B, 2] -> [B, num, 2]."""
    w1, w2 = _hash_counts(keys, num)
    return torch.stack([w1, w2], dim=-1)


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits`` (32-bit) of every row's key: [B, 2] -> [B, n]
    words in [0, 2^32) as int64."""
    w1, w2 = _hash_counts(keys, n)
    return w1 ^ w2


def uniform(keys: torch.Tensor, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32 of every row's key -> [B, n]: the
    top 23 bits as the mantissa of a float in [1, 2), minus 1, scaled into
    [minval, maxval) and floored at minval."""
    bits = (random_bits(keys, n) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=keys.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=keys.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


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
