"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds) and loaded with ctypes.  Libraries land in
``build/kernels/`` at the repository root, named by a hash of their
source, the shared ``csrc/*.cuh`` headers and the flags, so an edited
source or header is never served by a stale library.  The first launch
of a kernel builds it; ``build_all`` builds every source at once, one
``nvcc`` per source, all running together.  A library may export more
than one entry point (``EXTRA_ENTRIES``).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# dtype codes of the C interface; head dims the kernels are instantiated for
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_DTYPES = tuple(DTYPE_CODE)
HEAD_DIMS = (16, 32, 64, 128)

_P, _I = ctypes.c_void_p, ctypes.c_int
# argument types of each library's entry point (pointers and the stream as
# c_void_p: ctypes would pass a bare Python int as a 32-bit int)
SIGNATURES = {
    # dtype, q, k, v, cache_len, m, l, acc, out,
    # B, S, H, KV, D, span, nsplit, window, scale, stream
    "decode_attention": [_I] + [_P] * 8 + [_I] * 8 + [ctypes.c_float, _P],
    # dtype, q, k_new, v_new, k_cache, v_cache, base, chunk_lens, out,
    # B, T, S, H, KV, D, scale, stream
    "prefill_attention": [_I] + [_P] * 8 + [_I] * 6 + [ctypes.c_float, _P],
    # dtype, q, k_pages, v_pages, block_table, cache_len, m, l, acc, out,
    # B, H, KV, D, num_pages, page_size, max_pages, span, nsplit, scale, stream
    "decode_attention_paged": [_I] + [_P] * 9 + [_I] * 9 + [ctypes.c_float, _P],
    # dtype, q, k_pages, v_pages, block_table, base, chunk_lens, out,
    # B, T, H, KV, D, num_pages, page_size, max_pages, scale, stream
    "prefill_attention_paged": [_I] + [_P] * 7 + [_I] * 8 + [ctypes.c_float, _P],
    # dtype, q, k, v, out, strides (12 int64: b, head, seq of q, k, v, out),
    # B, S, H, KV, D, causal, scale, stream
    "flash_attention": [_I] + [_P] * 4 + [ctypes.POINTER(ctypes.c_longlong)]
                       + [_I] * 6 + [ctypes.c_float, _P],
    # keys, out, R, N, block, nb, P, stream
    "hash_partition": [_P] * 2 + [_I] * 5 + [_P],
    # dtype of x, dtype of w, x, w, out, rows, d, eps, stream
    "rmsnorm": [_I] * 2 + [_P] * 3 + [_I] * 2 + [ctypes.c_float, _P],
}
# further entry points of a library: name -> (library, argument types)
EXTRA_ENTRIES = {
    # esize, k_new, v_new, k_pages, v_pages, block_table, base, chunk_lens,
    # B, T, row_elems, num_pages, page_size, max_pages, stream
    "paged_scatter": ("prefill_attention_paged", [_I] + [_P] * 7 + [_I] * 6 + [_P]),
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit on the machine with the card")
    return path


def library_path(name: str) -> Path:
    """The library's path: a hash of its source, every shared header in
    ``csrc/`` (any source may include one) and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _start(name: str):
    """Start nvcc for one source; returns (process, output path, temp path)
    or None when the library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, out, tmp


def _finish(name: str, started) -> str:
    proc, out, tmp = started
    log = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: a reader never sees a half-written library
    (BUILD_DIR / f"{name}.log").write_text(log)
    return log


def build_all() -> Dict[str, str]:
    """Compile every kernel source in parallel; returns nvcc's output
    (ptxas register and shared-memory report) per source, or "" for a
    library that was already built."""
    started = {name: _start(name) for name in SIGNATURES}
    return {name: (_finish(name, s) if s is not None else "")
            for name, s in started.items()}


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use, with
    its entry point ``name`` and those ``EXTRA_ENTRIES`` gives it typed."""
    started = _start(name)
    if started is not None:
        _finish(name, started)
    lib = ctypes.CDLL(str(library_path(name)))
    entries = {name: SIGNATURES[name]}
    entries.update({e: args for e, (src, args) in EXTRA_ENTRIES.items() if src == name})
    for entry, argtypes in entries.items():
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


def current_stream(t: torch.Tensor) -> int:
    """The raw handle of the current CUDA stream on ``t``'s device (what
    ``torch.cuda.current_stream(t.device).cuda_stream`` gives, without
    building a Stream object on every launch)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def raise_on_error(name: str, err: int) -> None:
    """Raise if a launch of entry point ``name`` returned a CUDA error
    (``cudaGetLastError``)."""
    if err != 0:
        lib = EXTRA_ENTRIES[name][0] if name in EXTRA_ENTRIES else name
        msg = load(lib).kernel_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({msg})")
