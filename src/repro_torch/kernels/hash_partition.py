"""Hash-partition histograms: the CUDA kernel's wrapper and its plain
PyTorch version (mirror of ``repro.kernels.hash_partition``), pass 1 of
the dataframe shuffle's radix partition.

Each key's bucket is ``hash_u32(k) % P`` (``ref.hash_u32_ref``); pass 1
counts the buckets of every block of ``block`` keys, pass 2 (stable sort
by bucket and the offsets of the totals) stays in torch
(``partition_order``; ``dataframe.ops_dist._bucket_exchange`` does the
same per shard).  Beyond JAX, keys may carry a leading dimension of
independent rows (the shards of a table): ``[R, N]`` gives ``[R, nb, P]``
in one launch (``csrc/hash_partition.cu``).

The dispatcher takes the plain version for CPU tensors and launches the
kernel for CUDA tensors; there is no fallback between them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels import ref as _ref

# a block's [P] counters live in shared memory: at most the 227 KB a block
# may use on Hopper
MAX_BUCKETS = 232448 // 4


def _blocks(n: int, block: int):
    """(block, number of blocks) as JAX cuts ``n`` keys."""
    if n < 1 or block < 1:
        raise ValueError(f"need keys and a block >= 1, got n={n}, block={block}")
    block = min(block, n)
    return block, -(-n // block)


def hash_partition_histogram_plain(keys, *, num_buckets: int,
                                   block: int = 2048) -> torch.Tensor:
    """keys [N] or [R, N] of any integer type -> [nb, P] or [R, nb, P]
    int32 per-block bucket counts; the last block counts only real keys."""
    n = keys.shape[-1]
    block, nb = _blocks(n, block)
    if num_buckets < 1:
        raise ValueError(f"num_buckets must be >= 1, got {num_buckets}")
    bucket = _ref.hash_u32_ref(keys.reshape(-1, n)) % num_buckets
    # keys past N fall into a spare counter that is cut off
    bucket = F.pad(bucket, (0, nb * block - n), value=num_buckets)
    bucket = bucket.view(-1, nb, block)
    counts = torch.zeros((bucket.shape[0], nb, num_buckets + 1),
                         dtype=torch.int64, device=keys.device)
    counts.scatter_add_(2, bucket, torch.ones_like(bucket))
    return counts[..., :num_buckets].to(torch.int32).reshape(
        *keys.shape[:-1], nb, num_buckets)


def hash_partition_histogram_kernel(keys, *, num_buckets: int,
                                    block: int = 2048) -> torch.Tensor:
    """Launch the CUDA kernel (contiguous int32 CUDA keys [N] or [R, N]
    only, raises otherwise)."""
    if keys.device.type != "cuda":
        raise ValueError(f"hash kernel needs a CUDA tensor, got {keys.device}")
    if keys.dtype != torch.int32 or keys.ndim not in (1, 2) \
            or not keys.is_contiguous():
        raise ValueError(f"hash kernel takes contiguous int32 [N] or [R, N] "
                         f"keys, got {keys.dtype} {tuple(keys.shape)}")
    if not 1 <= num_buckets <= MAX_BUCKETS:
        raise ValueError(f"num_buckets {num_buckets} not in [1, {MAX_BUCKETS}]")
    R, n = keys.shape if keys.ndim == 2 else (1, keys.shape[0])
    if n >= 2 ** 31 or R > 65535:
        raise ValueError(f"keys [{R}, {n}]: at most 65535 rows of < 2^31 keys")
    block, nb = _blocks(n, block)
    out = torch.empty((R, nb, num_buckets), dtype=torch.int32, device=keys.device)
    if R:
        err = build.load("hash_partition").hash_partition(
            keys.data_ptr(), out.data_ptr(), R, n, block, nb, num_buckets,
            torch.cuda.current_stream(keys.device).cuda_stream)
        build.raise_on_error("hash_partition", err)
        build.count_launch(hash_partition_histogram_kernel)
    return out.reshape(*keys.shape[:-1], nb, num_buckets)


hash_partition_histogram_kernel.launches = 0


def hash_partition_histogram(keys, *, num_buckets: int,
                             block: int = 2048) -> torch.Tensor:
    """keys [N] or [R, N] -> [ceil(N/block), P] or [R, ...] int32
    per-block histograms.  CPU tensors take the plain version, CUDA
    tensors the kernel."""
    if keys.device.type == "cpu":
        return hash_partition_histogram_plain(keys, num_buckets=num_buckets,
                                              block=block)
    return hash_partition_histogram_kernel(keys, num_buckets=num_buckets,
                                           block=block)


def partition_order(keys, num_buckets: int, *, block: int = 2048):
    """keys [N] -> (order, bucket_offsets) such that ``keys[order]`` is
    bucket-contiguous and bucket p starts at ``offsets[p]`` (pass 1 on the
    kernel for CUDA keys, pass 2 in torch)."""
    hist = hash_partition_histogram(keys, num_buckets=num_buckets, block=block)
    bucket = _ref.hash_u32_ref(keys) % num_buckets
    order = torch.sort(bucket, stable=True).indices
    totals = hist.sum(0)
    offsets = torch.cumsum(totals, 0) - totals
    return order, offsets.to(torch.int32)
