"""Causal or full GQA flash-attention forward: the CUDA kernel's wrapper,
its plain PyTorch version, and the autograd ``Function`` that puts the
kernel on the training path (mirror of ``repro.kernels.flash_attention``).

q is ``[B, H, S, D]``, k and v ``[B, KV, S, D]`` with ``H = KV * G``
(query head h reads KV head h // G); the output is ``[B, H, S, D]`` in q's
dtype.  The kernel (``csrc/flash_attention.cu``) reads every tensor
through its strides, so ``[B, S, H, D]`` activations viewed as ``[B, H,
S, D]`` go in without a copy, and the output takes q's layout.

The JAX package has no backward for this kernel: its training forward
differentiates ``blocks.chunked_attention``.  So :class:`FlashAttention`
launches the kernel in its forward and, in its backward, recomputes the
port's ``chunked_attention`` under autograd: the gradients of the function
JAX differentiates, with O(chunk) memory.  Under remat the layer's
forward runs again in the backward pass, so the kernel launches twice
per layer and train step.

The dispatcher takes the plain version for CPU tensors (differentiated by
autograd directly) and the ``Function`` over the kernel for CUDA
tensors; there is no fallback between the two.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref as _ref

# the plain version of the kernel: fp32 softmax over the GQA-repeated K/V
flash_attention_plain = _ref.flash_attention_ref


def _check(q, k, v) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"flash kernel needs CUDA tensors, got {q.device}")
    if q.dtype not in build.KERNEL_DTYPES:
        raise ValueError(f"flash kernel takes fp32/bf16, got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
    B, H, S, D = q.shape
    KV = k.shape[1]
    if D not in build.HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {build.HEAD_DIMS}")
    if k.shape != (B, KV, S, D) or v.shape != k.shape or H % KV \
            or H // KV > 128 or B * KV > 65535:
        raise ValueError("shape mismatch: q [B,H,S,D], k/v [B,KV,S,D], "
                         "H % KV == 0, H/KV <= 128, B*KV <= 65535")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s last dim must be contiguous")


def flash_attention_kernel(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """Launch the CUDA kernel (CUDA tensors only, raises otherwise); no
    autograd.  Returns ``[B, H, S, D]`` laid out like q."""
    _check(q, k, v)
    B, H, S, D = q.shape
    out = torch.empty_like(q)  # keeps q's strides when q is dense
    strides = (ctypes.c_longlong * 12)(
        *(t.stride(i) for t in (q, k, v, out) for i in range(3)))
    lib = build.load("flash_attention")
    err = lib.flash_attention(
        build.DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), strides, B, S, H, k.shape[1], D, int(causal),
        ctypes.c_float(1.0 / math.sqrt(D)), build.current_stream(q))
    build.raise_on_error("flash_attention", err)
    flash_attention_kernel.launches += 1
    return out


flash_attention_kernel.launches = 0


class FlashAttention(torch.autograd.Function):
    """``forward_fn(q, k, v, causal=...)`` in the forward (the kernel on
    the card; the plain version in a CPU test), ``chunked_attention``
    recomputed under autograd in the backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_chunk, kv_chunk, forward_fn):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.q_chunk, ctx.kv_chunk = causal, q_chunk, kv_chunk
        return forward_fn(q, k, v, causal=causal)

    @staticmethod
    def backward(ctx, d_out):
        from repro_torch.models.blocks import chunked_attention

        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = chunked_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                causal=ctx.causal, q_chunk=ctx.q_chunk, kv_chunk=ctx.kv_chunk)
            dq, dk, dv = torch.autograd.grad(out.transpose(1, 2), (q, k, v),
                                             d_out)
        return dq, dk, dv, None, None, None, None


def flash_attention_autograd(q, k, v, *, causal: bool = True,
                             q_chunk: int = 1024, kv_chunk: int = 1024,
                             forward_fn=flash_attention_kernel) -> torch.Tensor:
    """The differentiable flash attention: ``forward_fn`` forward, the
    backward through ``chunked_attention`` at ``q_chunk`` x ``kv_chunk``."""
    return FlashAttention.apply(q, k, v, causal, q_chunk, kv_chunk, forward_fn)


def flash_attention(q, k, v, *, causal: bool = True, q_chunk: int = 1024,
                    kv_chunk: int = 1024) -> torch.Tensor:
    """q [B,H,S,D]; k, v [B,KV,S,D] -> [B,H,S,D], differentiable.  CPU
    tensors take the plain version, CUDA tensors the kernel (its backward
    recomputes ``chunked_attention`` at ``q_chunk`` x ``kv_chunk``)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    return flash_attention_autograd(q, k, v, causal=causal, q_chunk=q_chunk,
                                    kv_chunk=kv_chunk)
