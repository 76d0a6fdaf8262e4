"""Fused RMSNorm: the CUDA kernel's wrapper and its plain PyTorch version
(mirror of ``repro.kernels.rmsnorm``).

It computes the fused kernel's function (fp32 mean-square and rsqrt, the
scale multiplied in fp32, cast to x's dtype), which in bf16 is not the
model's norm: ``models.blocks.rmsnorm_apply`` multiplies in x's dtype and
does not call this kernel.  Its only entry point is ``ops.rmsnorm``.

The dispatcher takes the plain version for CPU tensors and launches the
kernel for CUDA tensors; there is no fallback between them.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref as _ref

rmsnorm_plain = _ref.rmsnorm_ref


def rmsnorm_kernel(x, w, *, eps: float = 1e-5) -> torch.Tensor:
    """Launch the CUDA kernel (contiguous fp32/bf16 CUDA tensors only,
    raises otherwise)."""
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"rmsnorm kernel needs x and w on one CUDA device, "
                         f"got {x.device} and {w.device}")
    if x.dtype not in build.DTYPE_CODE or w.dtype not in build.DTYPE_CODE:
        raise ValueError(f"rmsnorm kernel takes fp32/bf16, got {x.dtype}, {w.dtype}")
    d = x.shape[-1] if x.ndim else 0
    if d < 1 or w.shape != (d,):
        raise ValueError(f"x [..., d >= 1] and w [d], got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous")
    rows = x.numel() // d
    if rows >= 2 ** 31:
        raise ValueError(f"{rows} rows: at most 2^31 - 1")
    out = torch.empty_like(x)
    if rows:
        err = build.load("rmsnorm").rmsnorm(
            build.DTYPE_CODE[x.dtype], build.DTYPE_CODE[w.dtype], x.data_ptr(),
            w.data_ptr(), out.data_ptr(), rows, d, ctypes.c_float(eps),
            torch.cuda.current_stream(x.device).cuda_stream)
        build.raise_on_error("rmsnorm", err)
        build.count_launch(rmsnorm_kernel)
    return out


rmsnorm_kernel.launches = 0


def rmsnorm(x, w, *, eps: float = 1e-5) -> torch.Tensor:
    """x [..., d]; w [d] -> x's shape and dtype.  CPU tensors take the plain
    version, CUDA tensors the kernel."""
    if x.device.type == "cpu":
        return rmsnorm_plain(x, w, eps=eps)
    return rmsnorm_kernel(x, w, eps=eps)
