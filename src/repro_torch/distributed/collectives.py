"""Quantized gradient all-reduce over a process mesh axis (mirror of
``repro.distributed.collectives``).

``int8_psum``: block-wise int8 quantization of each rank's vector with a
per-block scale, the scales max-combined across ranks (``all_reduce(MAX)``)
so that every rank requantizes onto one grid, the int8 payloads summed as
int32 (``all_reduce(SUM)``) and dequantized.  As in JAX, the summed payload
is int32, so the wire carries as many bytes as an fp32 all-reduce (plus a
scale per block); the 4x saving JAX's docstring names would need an int8
wire.  ``compressed_grad_sync`` applies it leaf by leaf to a gradient tree,
with optional error feedback: each rank carries its own quantization error
(what it put in minus its own payload dequantized on the shared grid) into
the next sync.  JAX's ``carry_in - synced`` is that error on the replicated
input its ``shard_map`` is given (the same bits at a power-of-two axis);
on gradients that differ by rank it would also carry each rank's distance
from the mean, which grows a sync.  The arithmetic is JAX's op for op
(``torch.round`` rounds half to even, as ``jnp.round`` does; every
division is fp32 division).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.common.params import map_tree, tree_leaves


def _quantize_int8(x: torch.Tensor, block: int = 256):
    """x: [N] fp32 -> (q int8 [N + pad], scales fp32 [(N + pad) / block], pad)."""
    pad = (-x.shape[0]) % block
    xb = (F.pad(x, (0, pad)) if pad else x).reshape(-1, block)
    # divisors are tensors: torch on CUDA divides by a Python scalar by
    # multiplying with its reciprocal, one ulp off JAX's division
    scale = torch.clamp(xb.abs().amax(1, keepdim=True) / xb.new_tensor(127.0), min=1e-12)
    q = torch.clamp(torch.round(xb / scale), -127, 127).to(torch.int8)
    return q.reshape(-1), scale[:, 0], pad


def _dequantize_int8(q: torch.Tensor, scales: torch.Tensor, pad: int,
                     block: int = 256) -> torch.Tensor:
    x = (q.reshape(-1, block).float() * scales[:, None]).reshape(-1)
    return x[: x.shape[0] - pad] if pad else x


def int8_psum(x: torch.Tensor, mesh, axis: str, *, block: int = 256) -> torch.Tensor:
    """The quantized sum of ``x`` over the ranks of ``mesh``'s ``axis``
    (a ``ProcessMesh``), in ``x``'s shape and dtype, the same on every
    rank.  int32 accumulators do not overflow below ~2^24 ranks."""
    return _int8_sum(x, mesh, axis, block)[0]


def _int8_sum(x: torch.Tensor, mesh, axis: str, block: int):
    """``int8_psum``'s sum, and this rank's own payload dequantized on the
    shared grid (its term of the sum), both in ``x``'s shape and dtype."""
    group = mesh.group(axis)
    q, scales, pad = _quantize_int8(x.reshape(-1).float(), block)
    gmax = scales.clone()
    dist.all_reduce(gmax, op=dist.ReduceOp.MAX, group=group)
    requant = torch.clamp(
        torch.round((q.reshape(-1, block).float() * scales[:, None]) / gmax[:, None]),
        -127, 127).to(torch.int32)
    own = requant.float() * gmax[:, None]
    dist.all_reduce(requant, op=dist.ReduceOp.SUM, group=group)
    total = requant.float() * gmax[:, None]

    def shaped(v):
        v = v.reshape(-1)
        v = v[: v.shape[0] - pad] if pad else v
        return v.reshape(x.shape).to(x.dtype)
    return shaped(total), shaped(own)


def wire_bytes(x: torch.Tensor, *, block: int = 256) -> int:
    """Bytes ``int8_psum`` hands each all-reduce for ``x``: one fp32 scale
    per block and one int32 per element, padding included."""
    blocks = -(-x.numel() // block)
    return blocks * 4 + blocks * block * 4


def compressed_grad_sync(grads, mesh, axis: str = "data", *, block: int = 256,
                         error_feedback: Optional[dict] = None):
    """All-reduce the mean of a gradient tree (nested dicts and lists of
    tensors) with int8 compression over ``mesh``'s ``axis``.  Returns
    ``(synced_grads, new_error_feedback)``: the tree averaged over the
    axis's ranks, and each leaf's fp32 error on this rank (what went in,
    the carried error added, minus this rank's payload dequantized on the
    shared grid), to pass as ``error_feedback`` to the next sync."""
    n = mesh.shape[axis]
    efs = tree_leaves(error_feedback) if error_feedback is not None else None
    outs, new_ef = [], []
    for i, g in enumerate(tree_leaves(grads)):
        carry_in = g if efs is None else g + efs[i].to(g.dtype)
        total, own = _int8_sum(carry_in, mesh, axis, block)
        outs.append(total / g.new_tensor(n))
        new_ef.append((carry_in - own).float())
    it_out, it_ef = iter(outs), iter(new_ef)
    return (map_tree(lambda _: next(it_out), grads),
            map_tree(lambda _: next(it_ef), grads))
