#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Phases, each printing one JSON line per layout or run; any failure exits
non-zero:

1. build    compile ``src/repro_torch/kernels/csrc/*.cu`` with nvcc for
            sm_90a (one nvcc per source, all at once) into build/kernels/.
2. kernels  each of the seven kernels against its plain PyTorch version on
            the card.  The five attention kernels at full tinyllama-1.1b
            shapes and at the smoke shapes, fp32 and bf16: ragged, empty,
            full and past-the-end lengths, a scalar length, a window, an S
            that is not a power of two, sentinel table entries,
            page-straddling chunks, inert rows and chunks whose tokens run
            past the end of the cache; flash attention causal and full at
            the training shape, an S that is not a multiple of the tile,
            S = 1, D 16 and 128, and G = 1.  rmsnorm at [4096, 2048],
            [4, 17, 256] and [1, 5120] in fp32 and bf16 (RMS_TOL); the
            hash-partition histogram bitwise at n 1, 2047, 2048, 2049 and
            2^23 keys (negatives and the int32 extremes among them) for 4,
            8, 16, 64 and 4096 buckets.  The two kernels redesigned for
            the tensor cores also over sweeps: flash attention at S 1, 63,
            64, 65, 127, 512 and 1000, D 16 to 128, G 1 and 8, causal and
            full; the paged prefill at chunks of 1 to 64 tokens, bases 0 to
            500.  The paged cache scatter bitwise against the plain one on
            tests/paged_scatter_cases.py; the paged prefill wrapper and the
            decode append once under sync-debug "error" (a host sync
            fails the phase).  Then torch.profiler's device time
            per launch of rmsnorm and the hash at their paths' shapes
            (taken here: windows opened late in the run came back without
            device events).
3. serve    full-width tinyllama-1.1b (random weights from a seeded
            torch.Generator, bf16 compute) serves 16 greedy requests shaped
            like the repo's mixed workload through ``submit`` +
            ``run_until_drained``, once on the paged KV cache and once on
            the contiguous slot cache.  Every launch counter is zeroed just
            before each run and read just after: the layout's two kernels
            (and on the paged layout the cache scatter, once per prefill
            call and decode append) must have launched, no other kernel
            may have.
4. timing   each kernel's wrapper at the shapes of its path against its
            plain version and a PyTorch SDPA yardstick (CUDA events), with
            its roofline bound; for the paged prefill also the scatter
            kernel alone and the device time of its two kernels.
5. profile  torch.profiler over a separate serving run per layout: device
            busy and idle share, kernels and host ops per engine step, the
            port's kernels' device time per launch, top kernels.
6. stream   the same engines in fp32: on each layout the kernel path and
            the plain path, and the two layouts' kernel paths, must emit
            token-identical greedy streams.
7. train    full-width tinyllama-1.1b (random weights from a seeded
            torch.Generator, fp32 parameters, bf16 compute, the default
            RunConfig: AdamW, remat per layer, clip 1.0, lr 3e-4) takes 20
            steps on B 8 x S 512 batches of the synthetic corpus (labels:
            the tokens rolled by -1).  Counters zeroed just before, read
            just after: flash attention launches 44 times per step (22
            layers, and again in each layer's recompute under remat), the
            serving kernels never.  The mean loss of the last 5 steps must
            be below that of the first 5.  Then one profiled step, and the
            state saved with AsyncCheckpointer and restored into a fresh
            state, bitwise.
8. parity   fp32 training (TF32 off) from one initial state: 3 steps on
            the kernel path and 3 on the plain path (``decode_impl="ref"``);
            loss and grad-norm must agree at every step within TRAIN_TOL.
9. dataframe  a 2^26-row table (int32 keys uniform in [0, 2^20), float32
            v, x1, x2 and y = 3 x1 - 2 x2 + noise, from numpy at SEED) on 8
            logical shards of the card: shuffle, sort, join with a 2^20-row
            table (w = 10 k), groupby_sum (2^18 groups per shard) and
            reduce_sum.  Counters zeroed just before, read just after: the
            hash kernel launches exactly 4 times (shuffle 1, join 2,
            groupby 1).  Nothing dropped; the results pass numpy checks on
            the host; the same operators with impl="ref" give the same
            columns, masks and drops bitwise (groupby sums within
            DF_PAIR_ATOL: index_add_ adds with atomics on the card).
10. pipeline  the paper's preprocess -> bridge -> train -> postprocess
            without the pilot: filter |x1| < 3 on that table, a shuffled
            ZeroCopyLoader at global batch 65536, PIPE_STEPS SGD steps of a
            linear model (w_err < 0.2, loss falling), then HostPrefetcher
            over host batches (arrive equal; GB/s).
11. rmsnorm   the fused norm's entry point ``ops.rmsnorm`` on [4096, 2048]
            bf16 activations once per tinyllama layer (22 launches, counted
            as above); then the timing rows of kernels 6 and 7.

The last lines are the card (nvidia-smi name and power limit), the kernel
table ``{"kernels": [...]}`` and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import itertools
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))  # the scatter's edge cases

from repro_torch.bridge.loader import HostPrefetcher, ZeroCopyLoader  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.common.params import init_params, map_tree, tree_leaves  # noqa: E402
from repro_torch.configs import RunConfig, get_config  # noqa: E402
from repro_torch.dataframe import ops_dist as dfo  # noqa: E402
from repro_torch.dataframe.ops_local import filter_rows  # noqa: E402
from repro_torch.dataframe.table import Table  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import decode_attention as dec  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import hash_partition as hp  # noqa: E402
from repro_torch.kernels import prefill_attention as pf  # noqa: E402
from repro_torch.kernels import rmsnorm as rms  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.train import make_corpus  # noqa: E402
from repro_torch.models.lm import lm_paged_cache_specs  # noqa: E402
from repro_torch.serve import RequestState, ServeEngine  # noqa: E402
from repro_torch.train.state import init_train_state, model_specs  # noqa: E402
from repro_torch.train.step import make_prefill_chunk_step, make_train_step  # noqa: E402
import paged_scatter_cases  # noqa: E402

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
BF16_FLOPS_PER_S = 989e12     # H100 SXM dense bf16 tensor-core peak
FP32_FLOPS_PER_S = 67e12      # H100 SXM fp32 outside the tensor cores
# max abs error, kernel vs plain: fp32 sums in another order (~1e-6 seen);
# bf16 outputs may round one bf16 ulp apart (2^-6 at |x| in [2, 4))
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
ARCH = "tinyllama-1.1b"
PAGE = 16
MAX_LEN = 512
SEED = 0
LAYOUTS = ("paged", "contiguous")
# each wrapper's launch counter, and the kernels each path runs
COUNTED = {"decode_attention_paged": dec.decode_attention_paged_kernel,
           "prefill_attention_paged": pf.prefill_attention_paged_kernel,
           "paged_scatter": pf.write_chunk_paged_kernel,
           "decode_attention": dec.decode_attention_kernel,
           "prefill_attention": pf.prefill_attention_kernel,
           "flash_attention": fa.flash_attention_kernel,
           "rmsnorm": rms.rmsnorm_kernel,
           "hash_partition_histogram": hp.hash_partition_histogram_kernel}
# (the paged cache scatter is the second entry point of kernel 5's
# library: the prefill and every decode append launch it)
PATH_KERNELS = {"paged": ("decode_attention_paged", "prefill_attention_paged", "paged_scatter"),
                "contiguous": ("decode_attention", "prefill_attention"),
                "train": ("flash_attention",),
                "dataframe": ("hash_partition_histogram",),
                "rmsnorm": ("rmsnorm",)}
# each kernel's device symbols on its path (torch.profiler event names):
# the bf16 bodies that serving and training run (the fp32 bodies of
# kernels 1 and 5 are flash_fwd_kernel and prefill_kernel)
SYMBOLS = {"decode_attention_paged": ("decode_split_kernel", "decode_combine_kernel"),
           "prefill_attention_paged": ("prefill_paged_wgmma_kernel",),
           "paged_scatter": ("paged_scatter_kernel",),
           "decode_attention": ("contig_decode_split_kernel", "decode_combine_kernel"),
           "prefill_attention": ("chunk_scatter_kernel", "contig_prefill_kernel"),
           "flash_attention": ("flash_fwd_wgmma_kernel",),
           "rmsnorm": ("rmsnorm_kernel",),
           "hash_partition_histogram": ("hash_hist_kernel",)}
# the train phase: B x S tokens per step, as many steps; the kernel path
# and the plain path in fp32 must agree in loss and grad-norm within
# TRAIN_TOL (relative) at each of PARITY_STEPS steps: both are fp32 with
# TF32 off, but they sum in other orders (and the embedding gather's
# backward adds with atomics), which AdamW's normalised steps carry on
TRAIN_B, TRAIN_S, TRAIN_STEPS, PARITY_STEPS = 8, 512, 20, 3
TRAIN_TOL = {"loss": 1e-4, "grad_norm": 1e-3}
# rmsnorm, kernel vs plain, as atol = rtol (tests/test_kernels.py's
# tolerances): fp32 sums in another order; bf16 one ulp of the cast,
# which is 2^-7 of the value's power of two, so it grows with the value
RMS_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
RMS_SHAPE = (4096, 2048)  # tinyllama's training activations, B 8 x S 512
# the dataframe phase: rows of the left table on DF_SHARDS logical shards,
# keys uniform in [0, DF_KEYS), a right table of DF_KEYS rows, groupby
# slots per shard; the hash kernel launches once per hash exchange
DF_ROWS, DF_SHARDS, DF_KEYS, DF_GROUPS = 1 << 26, 8, 1 << 20, 1 << 18
DF_LAUNCHES = {"shuffle": 1, "sort": 0, "join": 2, "groupby": 1, "reduce": 0}
# float sums, host float64 vs the card's float32 (groupby: absolute, a
# group holds ~64 values; reduce: relative)
DF_SUM_TOL = 1e-3
# groupby sums, kernel run vs impl="ref" run (absolute): the same float32
# sums of ~64 values in another order (index_add_ adds with atomics)
DF_PAIR_ATOL = 1e-4
PIPE_BATCH, PIPE_STEPS = 65536, 1024


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def rotate(items):
    """A function returning the next of ``items`` on each call: one input
    set per layer, so repeated timing does not run out of L2."""
    cyc = itertools.cycle(items)
    return lambda: next(cyc)


# -- inputs ------------------------------------------------------------------


def randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def paged_pool(gen, B, KV, D, max_pages, lens, dtype):
    """Pools with spare pages and a scrambled table giving each row exactly
    the pages ``lens`` need; every other entry is a sentinel (>= num_pages)."""
    need = [-(-int(n) // PAGE) for n in lens]
    num_pages = sum(need) + 3
    ids = torch.randperm(num_pages, generator=gen, device="cuda").tolist()
    bt = torch.full((B, max_pages), num_pages, dtype=torch.int32)
    for b, n in enumerate(need):
        bt[b, :n] = torch.tensor(ids[:n], dtype=torch.int32)
        bt[b, n:] += b  # sentinels past num_pages too
        ids = ids[n:]
    kp = randn(gen, (num_pages, PAGE, KV, D), dtype)
    vp = randn(gen, (num_pages, PAGE, KV, D), dtype)
    return kp, vp, bt.cuda()


def i32(x):
    return torch.tensor(x, dtype=torch.int32, device="cuda")


def decode_case(gen, H, KV, D, max_pages, lens, dtype):
    B = len(lens)
    kp, vp, bt = paged_pool(gen, B, KV, D, max_pages, lens, dtype)
    return randn(gen, (B, H, D), dtype), kp, vp, bt, i32(lens)


def prefill_case(gen, T, H, KV, D, max_pages, base, clens, dtype):
    B = len(base)
    kp, vp, bt = paged_pool(gen, B, KV, D, max_pages,
                            [max(b + c, 1) for b, c in zip(base, clens)], dtype)
    return (randn(gen, (B, T, H, D), dtype), randn(gen, (B, T, KV, D), dtype),
            randn(gen, (B, T, KV, D), dtype), kp, vp, bt, i32(base), i32(clens))


def contig_decode_case(gen, H, KV, D, S, lens, dtype):
    """q and contiguous caches for ``lens`` (a list: one row each; an
    int: three rows sharing one scalar length)."""
    B = len(lens) if isinstance(lens, list) else 3
    return (randn(gen, (B, H, D), dtype), randn(gen, (B, S, KV, D), dtype),
            randn(gen, (B, S, KV, D), dtype), i32(lens))


def contig_prefill_case(gen, T, H, KV, D, S, base, clens, dtype):
    B = len(base)
    return (randn(gen, (B, T, H, D), dtype), randn(gen, (B, T, KV, D), dtype),
            randn(gen, (B, T, KV, D), dtype), randn(gen, (B, S, KV, D), dtype),
            randn(gen, (B, S, KV, D), dtype), i32(base), i32(clens))


def check_contig_decode(args, window=0):
    """(max abs error vs plain, empty rows exactly zero)."""
    got = dec.decode_attention_kernel(*args, window=window)
    want = dec.decode_attention_plain(*args, window=window)
    empty = args[3].expand(got.shape[0]) == 0
    return ((got.float() - want.float()).abs().max().item(),
            bool((got[empty] == 0).all()))


def check_contig_prefill(args):
    """(max abs error vs plain, caches equal and padding rows exactly
    zero); each side writes its own copy of the caches."""
    q, kn, vn, kc, vc, base, clens = args
    got, gk, gv = pf.prefill_attention_kernel(q, kn, vn, kc.clone(), vc.clone(),
                                              base, clens)
    want, wk, wv = pf.prefill_attention_plain(q, kn, vn, kc.clone(), vc.clone(),
                                              base, clens)
    pad = torch.arange(q.shape[1], device="cuda")[None, :] >= clens[:, None]
    ok = torch.equal(gk, wk) and torch.equal(gv, wv) and bool((got[pad] == 0).all())
    return (got.float() - want.float()).abs().max().item(), ok


def check_decode(args):
    """(max abs error vs plain, empty rows exactly zero)."""
    got = dec.decode_attention_paged_kernel(*args)
    want = dec.decode_attention_paged_plain(*args)
    empty = args[4] == 0
    return ((got.float() - want.float()).abs().max().item(),
            bool((got[empty] == 0).all()))


def check_prefill(args):
    """(max abs error vs plain, pools equal and padding rows exactly zero);
    each side writes its own copy of the pools."""
    q, kn, vn, kp, vp, bt, base, clens = args
    got, gk, gv = pf.prefill_attention_paged_kernel(
        q, kn, vn, kp.clone(), vp.clone(), bt, base, clens)
    want, wk, wv = pf.prefill_attention_paged_plain(
        q, kn, vn, kp.clone(), vp.clone(), bt, base, clens)
    pad = torch.arange(q.shape[1], device="cuda")[None, :] >= clens[:, None]
    ok = torch.equal(gk, wk) and torch.equal(gv, wv) and bool((got[pad] == 0).all())
    return (got.float() - want.float()).abs().max().item(), ok


def flash_case(gen, B, H, KV, S, D, dtype):
    """q, k, v as the model hands them over: [B, S, heads, D] activations
    viewed as [B, heads, S, D]."""
    return tuple(randn(gen, (B, S, n, D), dtype).transpose(1, 2)
                 for n in (H, KV, KV))


def check_flash(args, causal=True):
    """(max abs error vs plain, output shaped and typed like q)."""
    got = fa.flash_attention_kernel(*args, causal=causal)
    want = fa.flash_attention_plain(*args, causal=causal)
    ok = got.shape == args[0].shape and got.dtype == args[0].dtype
    return (got.float() - want.float()).abs().max().item(), ok


# -- phases ------------------------------------------------------------------


def phase_build():
    t0 = time.perf_counter()
    logs = build.build_all()
    secs = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if any(w in ln for w in ("entry function", "registers", "spill"))]
             for name, log in logs.items()}
    emit({"phase": "build", "ok": True, "seconds": secs, "gpu": gpu_line(),
          "nvcc": " ".join(build.NVCC_FLAGS), "ptxas": ptxas})


def phase_kernels():
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = []
    shapes = {"full": (32, 4, 64, 32, 64),   # H, KV, D, max_pages, chunk T
              "smoke": (8, 2, 16, 8, 8)}
    for dtype in (torch.float32, torch.bfloat16):
        for sname, (H, KV, D, mp, T) in shapes.items():
            S = PAGE * mp
            # empty row, one token, page edges, half, nearly full, full
            lens = [0, 1, PAGE - 1, PAGE, PAGE + 1, S // 2 + 3, S - 1, S]
            err, ok = check_decode(decode_case(gen, H, KV, D, mp, lens, dtype))
            cases.append({"kernel": "decode_attention_paged", "shape": sname,
                          "dtype": str(dtype), "max_abs_err": err,
                          "tol": TOL[dtype], "empty_rows_zero": ok})
            if not (err <= TOL[dtype] and ok):
                raise AssertionError(f"decode kernel disagrees: {cases[-1]}")
            # full chunk at 0, inside one page, inert row, straddling and
            # deep chunks, one ending on the last page, one token, one
            # straddling the first page edge
            base = [0, 5, 13, 100 % (S - T), 37 % (S - T), S - T, 0, PAGE - 4]
            clens = [T, 3, 0, T, T // 2 + 1, T, 1, T - 1]
            err, ok = check_prefill(prefill_case(gen, T, H, KV, D, mp, base,
                                                 clens, dtype))
            cases.append({"kernel": "prefill_attention_paged", "shape": sname,
                          "dtype": str(dtype), "max_abs_err": err,
                          "tol": TOL[dtype], "pools_equal_pad_zero": ok})
            if not (err <= TOL[dtype] and ok):
                raise AssertionError(f"prefill kernel disagrees: {cases[-1]}")
            # contiguous decode: empty row, one token, S-1, S, past S; a
            # scalar length; a window; an S that is not a power of two
            for case, S2, lens, window in (
                    ("lengths", S, [0, 1, 37, S // 2 + 3, S - 1, S, S + 5], 0),
                    ("scalar", S, S // 2 + 1, 0),
                    ("window", S, [5, 40, S // 2, S], 40),
                    ("S=200", 200, [0, 1, 100, 199, 200], 0)):
                err, ok = check_contig_decode(
                    contig_decode_case(gen, H, KV, D, S2, lens, dtype), window)
                cases.append({"kernel": "decode_attention", "shape": sname,
                              "case": case, "dtype": str(dtype),
                              "max_abs_err": err, "tol": TOL[dtype],
                              "empty_rows_zero": ok})
                if not (err <= TOL[dtype] and ok):
                    raise AssertionError(f"contiguous decode kernel disagrees: "
                                         f"{cases[-1]}")
            # contiguous prefill: a full chunk at 0, a partial chunk, an
            # inert row, a chunk ending exactly at S with padding past it,
            # a chunk whose valid tokens run past S (they drop), a row
            # wholly past S
            base = [0, 37, 5, S - T // 2, S - 3, S + 2]
            clens = [T, T // 2 + 1, 0, T // 2, T, 4]
            err, ok = check_contig_prefill(contig_prefill_case(
                gen, T, H, KV, D, S, base, clens, dtype))
            cases.append({"kernel": "prefill_attention", "shape": sname,
                          "dtype": str(dtype), "max_abs_err": err,
                          "tol": TOL[dtype], "caches_equal_pad_zero": ok})
            if not (err <= TOL[dtype] and ok):
                raise AssertionError(f"contiguous prefill kernel disagrees: "
                                     f"{cases[-1]}")
        # flash attention: the training shape, an S that is not a multiple
        # of the tile, S = 1, D 16 and 128, G = 1; causal and full
        for causal in (True, False):
            for B, H, KV, S, D in ((TRAIN_B, 32, 4, TRAIN_S, 64), (2, 32, 4, 200, 64),
                                   (3, 8, 2, 1, 64), (2, 8, 2, 77, 16),
                                   (1, 8, 8, 130, 128)):
                err, ok = check_flash(flash_case(gen, B, H, KV, S, D, dtype), causal)
                cases.append({"kernel": "flash_attention", "causal": causal,
                              "shape": [B, H, KV, S, D], "dtype": str(dtype),
                              "max_abs_err": err, "tol": TOL[dtype],
                              "shape_dtype_ok": ok})
                if not (err <= TOL[dtype] and ok):
                    raise AssertionError(f"flash kernel disagrees: {cases[-1]}")
        cases += redesigned_sweeps(gen, dtype)
        # rmsnorm: the training activations, the shapes of
        # tests/test_kernels.py, a block per row (d 5120)
        for shape in (RMS_SHAPE, (4, 17, 256), (1, 5120)):
            x, w = randn(gen, shape, dtype), randn(gen, shape[-1:], dtype)
            out = rms.rmsnorm_kernel(x, w)
            got, want = out.float(), rms.rmsnorm_plain(x, w).float()
            tol = RMS_TOL[dtype]
            diff = (got - want).abs()
            cases.append({"kernel": "rmsnorm", "shape": list(shape), "dtype": str(dtype),
                          "max_abs_err": diff.max().item(),
                          "max_err_over_tol": (diff / (tol + tol * want.abs())).max().item(),
                          "atol_rtol": tol})
            if not (cases[-1]["max_err_over_tol"] <= 1 and out.dtype == dtype
                    and out.shape == x.shape):
                raise AssertionError(f"rmsnorm kernel disagrees: {cases[-1]}")
    # the hash histogram: counts are integers, so bitwise
    for n in (1, 2047, 2048, 2049, 1 << 23):
        keys = hash_keys(gen, n)
        for P in (4, 8, 16, 64, 4096):
            got = hp.hash_partition_histogram_kernel(keys, num_buckets=P)
            ok = torch.equal(got, hp.hash_partition_histogram_plain(keys, num_buckets=P))
            cases.append({"kernel": "hash_partition_histogram", "n": n, "buckets": P,
                          "blocks": got.shape[0], "bitwise_equal": ok})
            if not ok:
                raise AssertionError(f"hash kernel disagrees: {cases[-1]}")
    cases += scatter_cases(gen)
    cases.append(check_no_host_sync(gen))
    emit({"phase": "kernels", "ok": True, "kernels": list(COUNTED),
          "cases": cases})


def redesigned_sweeps(gen, dtype):
    """The two kernels redesigned for the tensor cores, on their edges:
    flash attention at every S around the 128-row block and 64-key tile,
    the training S and a long ragged one, D 16 to 128, G 1 and 8, causal
    and full, on [B, S, H, D] views; the paged prefill at chunks of 1 to
    64 tokens, bases 0 to 500 (a chunk running past max_pages), sentinels
    in every table, pools bitwise, padding rows zero.  One summary per
    kernel; any case past the tolerance fails the phase."""
    worst, n = 0.0, 0
    for S, D, G, causal in itertools.product((1, 63, 64, 65, 127, 512, 1000),
                                             (16, 32, 64, 128), (1, 8), (True, False)):
        err, ok = check_flash(flash_case(gen, 2, 2 * G, 2, S, D, dtype), causal)
        n, worst = n + 1, max(worst, err)
        if not (err <= TOL[dtype] and ok):
            raise AssertionError(f"flash kernel disagrees at S {S} D {D} G {G} "
                                 f"causal {causal} {dtype}: {err}")
    out = [{"kernel": "flash_attention", "sweep": "S x D x G x causal", "cases": n,
            "dtype": str(dtype), "max_abs_err": worst, "tol": TOL[dtype]}]
    worst, n = 0.0, 0
    base = [0, 5, 16, 447, 500, 3]
    for T in (1, 15, 16, 17, 64):
        clens = [T, max(T - 3, 0), T, T, T, 0]
        err, ok = check_prefill(sweep_prefill_case(gen, T, base, clens, dtype))
        n, worst = n + 1, max(worst, err)
        if not (err <= TOL[dtype] and ok):
            raise AssertionError(f"paged prefill kernel disagrees at T {T} {dtype}: "
                                 f"{err}, pools equal and padding zero: {ok}")
    out.append({"kernel": "prefill_attention_paged", "sweep": "T x base", "cases": n,
                "dtype": str(dtype), "max_abs_err": worst, "tol": TOL[dtype],
                "pools_equal_pad_zero": True})
    return out


def sweep_prefill_case(gen, T, base, clens, dtype, H=32, KV=4, D=64, max_pages=32):
    """Full tinyllama widths; each row gets the pages its prefix needs
    (capped at max_pages), every other entry a sentinel up to 1000 * row
    past num_pages."""
    need = [min(-(-(b + c) // PAGE), max_pages) for b, c in zip(base, clens)]
    num_pages = sum(need) + 2
    ids = torch.randperm(num_pages, generator=gen, device="cuda").tolist()
    bt = torch.full((len(base), max_pages), num_pages, dtype=torch.int32)
    for b, n in enumerate(need):
        bt[b, :n] = torch.tensor(ids[:n], dtype=torch.int32)
        bt[b, n:] += 1000 * b
        ids = ids[n:]
    B = len(base)
    return (randn(gen, (B, T, H, D), dtype), randn(gen, (B, T, KV, D), dtype),
            randn(gen, (B, T, KV, D), dtype), randn(gen, (num_pages, PAGE, KV, D), dtype),
            randn(gen, (num_pages, PAGE, KV, D), dtype), bt.cuda(), i32(base), i32(clens))


def scatter_cases(gen):
    """The scatter entry point bitwise against the plain write_chunk_paged
    on tests/paged_scatter_cases.py's edge cases, fp32 and bf16."""
    out = []
    sc = paged_scatter_cases
    for dtype in (torch.float32, torch.bfloat16):
        for case, (num_pages, (base, clens, bt)) in sorted(sc.SCATTER_CASES.items()):
            kp, vp = (randn(gen, (num_pages, sc.PAGE, 2, 16), dtype) for _ in range(2))
            kn, vn = (randn(gen, (sc.B, sc.T, 2, 16), dtype) for _ in range(2))
            bt, bs, cl = i32(bt), i32(base), i32(clens)
            gk, gv = pf.write_chunk_paged_kernel(kp.clone(), vp.clone(), bt, kn, vn, bs, cl)
            ok = (torch.equal(gk, pf.write_chunk_paged(kp.clone(), bt, kn, bs, cl))
                  and torch.equal(gv, pf.write_chunk_paged(vp.clone(), bt, vn, bs, cl)))
            out.append({"kernel": "paged_scatter", "case": case, "dtype": str(dtype),
                        "bitwise_equal": ok})
            if not ok:
                raise AssertionError(f"paged scatter kernel disagrees: {out[-1]}")
    return out


def check_no_host_sync(gen):
    """The paged prefill wrapper (scatter + attention) and the decode
    append on the kernel, once each under sync-debug "error": a host sync
    raises and fails the phase."""
    q, kn, vn, kp, vp, bt, bs, cl = sweep_prefill_case(
        gen, 64, [64, 0, 0, 0], [64, 0, 5, 0], torch.bfloat16, max_pages=8)
    idx = i32([5, 17, -1, 127])
    kr, vr = randn(gen, (4, 4, 64), torch.bfloat16), randn(gen, (4, 4, 64), torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pf.prefill_attention_paged_kernel(q, kn, vn, kp, vp, bt, bs, cl)
        ops.paged_append(kp, vp, bt, idx, kr, vr)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return {"kernel": "prefill_attention_paged", "check": "no host sync",
            "calls": ["prefill_attention_paged_kernel", "ops.paged_append"],
            "sync_debug_mode": "error", "ok": True}


def hash_keys(gen, n):
    """n int32 keys over the whole int32 range, the extremes first."""
    keys = torch.randint(-2 ** 31, 2 ** 31, (n,), generator=gen, device="cuda",
                         dtype=torch.int64).to(torch.int32)
    ext = torch.tensor([-1, 0, 1, 2 ** 31 - 1, -2 ** 31], dtype=torch.int32)[:n]
    keys[:len(ext)] = ext.cuda()
    return keys


def mixed_requests(n: int, vocab: int, seed: int):
    """The repo's mixed workload shape (benchmarks/workload.py) at the real
    vocabulary: ~80% prompts of 4-16 tokens, ~20% of 96-160 (at least two),
    16-32 new tokens each."""
    rng = np.random.default_rng(seed)
    is_long = rng.random(n) < 0.2
    is_long[: max(2, n // 16)] = True
    lens = np.where(is_long, rng.integers(96, 161, n), rng.integers(4, 17, n))
    gens = rng.integers(16, 33, n)
    prompts = [rng.integers(1, vocab, int(l)).astype(np.int32) for l in lens]
    return list(zip(prompts, gens.tolist()))


def serve_engine(cfg, params, **kw):
    return ServeEngine(cfg, max_slots=8, max_len=MAX_LEN, page_size=PAGE,
                       prefill_chunk_tokens=64, params=params, **kw)


def zero_counts() -> None:
    for fn in COUNTED.values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in COUNTED.items()}


def phase_serve(cfg, params, layout):
    """The main path on one KV layout: every counter zeroed just before
    the run and read just after."""
    work = mixed_requests(16, cfg.vocab_size, SEED)
    warm = serve_engine(cfg, params, kv_layout=layout)  # cuBLAS, libraries
    for p, _ in work[:2]:
        warm.submit(p, max_new_tokens=4)
    warm.run_until_drained()
    del warm

    eng = serve_engine(cfg, params, kv_layout=layout)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new_tokens=g) for p, g in work]
    eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    bad = [r.rid for r in reqs
           if r.state is not RequestState.DONE or len(r.tokens) != r.max_new_tokens
           or not all(0 <= t < cfg.padded_vocab for t in r.tokens)]
    if bad:
        raise AssertionError(f"requests not served in full: {bad}")
    dec_name, pf_name = PATH_KERNELS[layout][:2]
    if min(launches[n] for n in PATH_KERNELS[layout]) <= 0:
        raise AssertionError(f"a kernel never launched on the {layout} path: "
                             f"{launches}")
    if layout == "paged" and launches["paged_scatter"] != launches[dec_name] + launches[pf_name]:
        raise AssertionError(f"the paged scatter launched {launches['paged_scatter']} "
                             f"times, not once per prefill call and decode append")
    others = {n: c for n, c in launches.items() if n not in PATH_KERNELS[layout]}
    if any(others.values()):
        raise AssertionError(f"the {layout} path launched another layout's "
                             f"kernels: {others}")
    stats = eng.stats()
    if stats["kv_layout"] != layout:
        raise AssertionError(f"engine reports layout {stats['kv_layout']}")
    ttft = np.array([r.ttft_s for r in reqs]) * 1e3
    gaps = np.array([g for r in reqs for g in r.inter_token_s]) * 1e3
    tokens = sum(len(r.tokens) for r in reqs)
    out = {"phase": "serve", "ok": True, "kv_layout": layout, "arch": cfg.name,
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "compute_dtype": str(cfg.compute_dtype), "requests": len(reqs),
           "tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
           "ttft_ms_p50": float(np.percentile(ttft, 50)),
           "ttft_ms_p95": float(np.percentile(ttft, 95)),
           # one decode step emits one token per decoding slot, so the gap
           # between a request's tokens is one engine step (with its
           # prefill chunk, when one ran)
           "step_ms_p50": float(np.percentile(gaps, 50)),
           "step_ms_p95": float(np.percentile(gaps, 95)),
           "decode_steps": stats["decode_steps"],
           "prefill_chunks": stats["prefill_chunks"],
           "launches": launches,
           "launches_per_decode_step": launches[dec_name] / stats["decode_steps"],
           "launches_per_prefill_chunk": launches[pf_name] / stats["prefill_chunks"],
           "kv_cache_capacity_bytes": stats["kv_cache_capacity_bytes"],
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(out)
    # the widest buckets the run used, and the first eight requests' final
    # lengths, shape the timing inputs
    shapes = {"lens": [len(p) + g for p, g in work[:8]]}
    if layout == "paged":
        shapes["decode_mb"] = max(mb for mb, _ in eng._seen_shapes["decode"])
        shapes["prefill_T_mb"] = max(eng._seen_shapes["prefill"])
    return out, shapes


def kernel_row(name, replaces, launches, err, ms, plain_ms, bytes_, flops,
               lib_ms, lib_note, at, source=None, flops_per_s=BF16_FLOPS_PER_S):
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source or name}.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms, "library_note": lib_note,
            "bytes": bytes_, "flops": flops, "at": at}


PAGED_SDPA = ("SDPA over K/V pre-gathered to contiguous [B,H,S,D]: no table "
              "gather, no cache write")
CONTIG_SDPA = ("SDPA over the cache with K/V pre-expanded to [B,H,S,D] and a "
               "length (decode) or causal (prefill) mask: no cache write")


def sdpa_inputs(q, kp, vp, bt, mask, H, KV):
    """The library yardstick's inputs: K/V gathered through the table and
    repeated to every head ahead of time, so its call does less work."""
    k = ref._gather_pages(kp, bt).repeat_interleave(H // KV, 2).transpose(1, 2)
    v = ref._gather_pages(vp, bt).repeat_interleave(H // KV, 2).transpose(1, 2)
    return q, k.contiguous(), v.contiguous(), mask


def sdpa(q, k, v, mask):
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def contig_sdpa_inputs(q, k, v, mask, H, KV):
    """The library yardstick's inputs over a contiguous cache: K/V repeated
    to every head ahead of time, so its call does less work."""
    k = k.repeat_interleave(H // KV, 2).transpose(1, 2).contiguous()
    v = v.repeat_interleave(H // KV, 2).transpose(1, 2).contiguous()
    return q, k, v, mask


def causal_mask(base, T, S):
    """[B, 1, T, S]: key position <= the query's position base + t."""
    qpos = base[:, None] + torch.arange(T, device="cuda")[None, :]
    kpos = torch.arange(S, device="cuda")
    return (kpos[None, None, :] <= qpos[:, :, None])[:, None]


def prefill_bytes(base, clens, T, B, H, KV, D, esz, index_bytes):
    valid_q = sum(clens)
    prefix = sum(b + c for b, c in zip(base, clens))
    return (2 * 2 * valid_q * KV * D * esz   # fresh K/V read, written to cache
            + 2 * prefix * KV * D * esz      # each row's prefix read
            + valid_q * H * D * esz          # valid queries read
            + B * T * H * D * esz            # out written, padding rows too
            + index_bytes)                   # table, base, lengths


def prefill_flops(base, clens, H, D):
    return 4 * H * D * sum(b + i + 1 for b, c in zip(base, clens) for i in range(c))


def phase_timing(cfg, launches, shapes):
    """Each wrapper at the serving shapes, rotating over one input set per
    layer so the pools are not served from L2 (as on the real path)."""
    dt = cfg.compute_dtype
    H, KV, D, L, B = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.num_layers, 8
    esz = torch.finfo(dt).bits // 8
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    rows = []

    mb = shapes["decode_mb"]
    lens = [min(n, mb * PAGE) for n in shapes["lens"]]
    cases = [decode_case(gen, H, KV, D, mb, lens, dt) for _ in range(L)]
    err = max(check_decode(a)[0] for a in cases[:2])
    nxt = rotate(cases)
    ms = cuda_ms(lambda: dec.decode_attention_paged_kernel(*nxt()))
    plain_ms = cuda_ms(lambda: dec.decode_attention_paged_plain(*nxt()))
    lib = rotate([sdpa_inputs(q[:, :, None], kp, vp, bt,
                              (torch.arange(mb * PAGE, device="cuda")[None, :]
                               < cl[:, None])[:, None, None, :], H, KV)
                  for q, kp, vp, bt, cl in cases])
    lib_ms = cuda_ms(lambda: sdpa(*lib()))
    live = sum(lens)
    bytes_ = (2 * live * KV * D * esz          # live K and V, read once
              + 2 * B * H * D * esz            # q read, out written
              + 4 * B * (mb + 1))              # table and lengths
    rows.append(kernel_row(
        "decode_attention_paged", "src/repro/kernels/decode_attention.py:199",
        launches, err, ms, plain_ms, bytes_, 4 * H * D * live, lib_ms, PAGED_SDPA,
        {"B": B, "H": H, "KV": KV, "D": D, "page": PAGE, "max_pages": mb,
         "cache_len": lens, "dtype": str(dt)}))

    # a 64-token chunk of a long prompt at base 64 while the other rows
    # decode (inert in this call): the widest chunk the main path runs
    T, mbp = shapes["prefill_T_mb"]
    base, clens = [64] + [0] * (B - 1), [T] + [0] * (B - 1)
    cases = [prefill_case(gen, T, H, KV, D, mbp, base, clens, dt) for _ in range(L)]
    err = max(check_prefill(a)[0] for a in cases[:2])
    nxt = rotate(cases)
    ms = cuda_ms(lambda: pf.prefill_attention_paged_kernel(*nxt()))
    plain_ms = cuda_ms(lambda: pf.prefill_attention_paged_plain(*nxt()))

    def scatter():  # the wrapper's cache write alone: the scatter kernel
        q, kn, vn, kp, vp, bt, bs, cl = nxt()
        pf.write_chunk_paged_kernel(kp, vp, bt, kn, vn, bs, cl)

    scatter_ms = cuda_ms(scatter)
    split = profiled_us(lambda: pf.prefill_attention_paged_kernel(*nxt()),
                        SYMBOLS["paged_scatter"] + SYMBOLS["prefill_attention_paged"])
    lib = rotate([sdpa_inputs(q.transpose(1, 2).contiguous(), kp, vp, bt,
                              causal_mask(bs, T, mbp * PAGE), H, KV)
                  for q, kn, vn, kp, vp, bt, bs, cl in cases])
    lib_ms = cuda_ms(lambda: sdpa(*lib()))
    rows.append(kernel_row(
        "prefill_attention_paged", "src/repro/kernels/prefill_attention.py:222",
        launches, err, ms, plain_ms,
        prefill_bytes(base, clens, T, B, H, KV, D, esz, 4 * B * (mbp + 2)),
        prefill_flops(base, clens, H, D), lib_ms, PAGED_SDPA,
        {"B": B, "T": T, "H": H, "KV": KV, "D": D, "page": PAGE, "max_pages": mbp,
         "base": base, "chunk_lens": clens, "dtype": str(dt),
         "scatter_ms": scatter_ms, "scatter": "paged_scatter_kernel"}))
    redesigned(rows[-1], sum(split.values()), split)

    # the contiguous slot cache: each slot owns a [MAX_LEN, KV, D] row
    S = MAX_LEN
    lens = [min(n, S) for n in shapes["lens"]]
    cases = [contig_decode_case(gen, H, KV, D, S, lens, dt) for _ in range(L)]
    err = max(check_contig_decode(a)[0] for a in cases[:2])
    nxt = rotate(cases)
    ms = cuda_ms(lambda: dec.decode_attention_kernel(*nxt()))
    plain_ms = cuda_ms(lambda: dec.decode_attention_plain(*nxt()))
    lib = rotate([contig_sdpa_inputs(
        q[:, :, None], k, v,
        (torch.arange(S, device="cuda")[None, :] < cl[:, None])[:, None, None, :],
        H, KV) for q, k, v, cl in cases])
    lib_ms = cuda_ms(lambda: sdpa(*lib()))
    live = sum(lens)
    bytes_ = (2 * live * KV * D * esz          # live K and V, read once
              + 2 * B * H * D * esz            # q read, out written
              + 4 * B)                         # lengths
    rows.append(kernel_row(
        "decode_attention", "src/repro/kernels/decode_attention.py:114",
        launches, err, ms, plain_ms, bytes_, 4 * H * D * live, lib_ms, CONTIG_SDPA,
        {"B": B, "H": H, "KV": KV, "D": D, "S": S, "cache_len": lens,
         "window": 0, "dtype": str(dt)}))

    cases = [contig_prefill_case(gen, T, H, KV, D, S, base, clens, dt)
             for _ in range(L)]
    err = max(check_contig_prefill(a)[0] for a in cases[:2])
    nxt = rotate(cases)
    ms = cuda_ms(lambda: pf.prefill_attention_kernel(*nxt()))
    plain_ms = cuda_ms(lambda: pf.prefill_attention_plain(*nxt()))
    lib = rotate([contig_sdpa_inputs(q.transpose(1, 2).contiguous(), kc, vc,
                                     causal_mask(bs, T, S), H, KV)
                  for q, kn, vn, kc, vc, bs, cl in cases])
    lib_ms = cuda_ms(lambda: sdpa(*lib()))
    rows.append(kernel_row(
        "prefill_attention", "src/repro/kernels/prefill_attention.py:162",
        launches, err, ms, plain_ms,
        prefill_bytes(base, clens, T, B, H, KV, D, esz, 4 * B * 2),
        prefill_flops(base, clens, H, D), lib_ms, CONTIG_SDPA,
        {"B": B, "T": T, "H": H, "KV": KV, "D": D, "S": S, "base": base,
         "chunk_lens": clens, "dtype": str(dt)}))
    emit({"phase": "timing", "ok": True, "rows": rows})
    return rows


def redesigned(row, device_us, split=None):
    """The fields of a kernel redesigned for the tensor cores: its design,
    its device time per call at the row's shape and the share of the
    bound that time and the wrapper's time reach."""
    row.update({"design": "wgmma", "header": "src/repro_torch/kernels/csrc/attn_tc.cuh",
                "device_us_per_launch": device_us,
                "bound_share_device": row["bound_ms"] * 1e3 / device_us,
                "bound_share_wrapper": row["bound_ms"] / row["ms"]})
    if split:
        row["device_us_by_kernel"] = split


def device_kernels(prof):
    """The profiler's device kernels and ``{name: [device ms, launches]}``."""
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in kernels:
        acc = by_name.setdefault(e.name, [0.0, 0])
        acc[0] += e.time_range.elapsed_us() / 1e3
        acc[1] += 1
    return kernels, by_name


def phase_profile(cfg, params, layout, n: int = 8):
    """Where a serving run's time goes on one layout: torch.profiler over
    the first ``n`` requests of the workload (a separate, unmeasured run;
    the profiler's own host cost inflates the wall time and the idle
    share).  Returns the device time per launch of the layout's kernels."""
    from torch.profiler import ProfilerActivity, profile

    work = mixed_requests(16, cfg.vocab_size, SEED)[:n]
    eng = serve_engine(cfg, params, kv_layout=layout)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for p, g in work:
            eng.submit(p, max_new_tokens=g)
        eng.run_until_drained()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels, by_name = device_kernels(prof)
    busy_ms = sum(v[0] for v in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    # the port's own kernels: device time per launch, free of the host
    # cost that the CUDA-event timing of back-to-back wrapper calls carries
    ours = {}
    for kernel in PATH_KERNELS[layout]:
        for name in SYMBOLS[kernel]:
            hits = [v for k, v in by_name.items() if f"::{name}<" in k]
            ms, launches = sum(v[0] for v in hits), sum(v[1] for v in hits)
            if not launches:
                raise AssertionError(f"the profiler saw no {name} launch")
            ours[name] = {"ms": ms, "launches": launches,
                          "us_per_launch": 1e3 * ms / launches}
    stats = eng.stats()
    steps = stats["decode_steps"] + stats["prefill_chunks"]
    cpu_ops = sum(1 for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CPU
                  and e.name.startswith("aten::") and e.cpu_parent is None)
    emit({"phase": "profile", "ok": True, "kv_layout": layout, "requests": n,
          "wall_ms": wall_ms,
          "device_busy_ms": busy_ms,
          "device_idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
          "gpu_kernels": len(kernels), "engine_steps": steps,
          "gpu_kernels_per_step": len(kernels) / steps,
          "top_level_aten_ops_per_step": cpu_ops / steps,
          "port_kernels": ours,
          "top_kernels": [{"name": k[:80], "ms": v[0], "launches": v[1]}
                          for k, v in top]})
    return {kernel: sum(ours[name]["us_per_launch"] for name in SYMBOLS[kernel])
            for kernel in PATH_KERNELS[layout]}


def top2_gap(cfg, params, prompt, prefix):
    """Top-2 logit gap of the plain path where two streams part."""
    cfg = cfg.with_overrides(decode_impl="ref")
    toks = np.concatenate([prompt, np.asarray(prefix, np.int32)])
    pages = -(-len(toks) // PAGE)
    cache = map_tree(lambda p: torch.zeros(p.shape, dtype=p.dtype, device="cuda"),
                     lm_paged_cache_specs(cfg, pages, PAGE))
    _, last, _ = make_prefill_chunk_step(cfg)(
        params, i32(toks[None]), i32([0]), i32([len(toks)]), cache,
        i32([list(range(pages))]))
    top = torch.topk(last[0].float(), 2).values
    return float(top[0] - top[1])


def phase_stream(cfg, params, n: int = 4):
    """fp32 greedy streams, token for token: on each layout the kernel
    path equals the plain path, and the contiguous kernel path equals the
    paged one."""
    cfg32 = cfg.with_overrides(compute_dtype=torch.float32)
    work = mixed_requests(n, cfg.vocab_size, SEED + 2)
    streams = {}
    for layout in LAYOUTS:
        for impl in ("auto", "ref"):
            eng = serve_engine(cfg32, params, decode_impl=impl, kv_layout=layout)
            reqs = [eng.submit(p, max_new_tokens=g) for p, g in work]
            eng.run_until_drained()
            streams[layout, impl] = [r.tokens for r in reqs]
    pairs = ((("paged", "auto"), ("paged", "ref")),
             (("contiguous", "auto"), ("contiguous", "ref")),
             (("contiguous", "auto"), ("paged", "auto")))
    for x, y in pairs:
        for i, (a, b) in enumerate(zip(streams[x], streams[y])):
            if a != b:
                step = next(j for j, (s, t) in enumerate(zip(a, b)) if s != t)
                emit({"phase": "stream", "ok": False, "request": i,
                      "streams": ["/".join(x), "/".join(y)],
                      "first_diverging_step": step, "tokens": [a[step], b[step]],
                      "plain_top2_logit_gap": top2_gap(cfg32, params, work[i][0],
                                                       streams["paged", "ref"][i][:step])})
                raise AssertionError(f"greedy streams {x} and {y} diverge")
    emit({"phase": "stream", "ok": True, "requests": n,
          "tokens": sum(len(s) for s in streams["paged", "auto"]),
          "compute_dtype": str(cfg32.compute_dtype),
          "identical": ["paged kernel == paged plain",
                        "contiguous kernel == contiguous plain",
                        "contiguous kernel == paged kernel"]})


def corpus_batches(cfg, steps: int):
    """``steps`` batches of B x S tokens of the synthetic corpus, labels
    the tokens rolled by -1, as the JAX package's launch/train.py builds them."""
    corpus = make_corpus(cfg.vocab_size, TRAIN_B * TRAIN_S * (steps + 8), SEED)
    rows = corpus[: len(corpus) // TRAIN_S * TRAIN_S].reshape(-1, TRAIN_S)
    out = []
    for i in range(steps):
        lo = (i * TRAIN_B) % max(rows.shape[0] - TRAIN_B, 1)
        tokens = torch.from_numpy(rows[lo:lo + TRAIN_B]).cuda()
        out.append({"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)})
    return out


def profile_train_step(step_fn, state, batch):
    """One train step under torch.profiler: device busy and idle share,
    time by kernel class, the flash kernel's device time per launch."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        metrics["loss"].item()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels, by_name = device_kernels(prof)
    busy_ms = sum(v[0] for v in by_name.values())
    (flash_symbol,) = SYMBOLS["flash_attention"]
    hits = [v for k, v in by_name.items() if flash_symbol in k]
    flash_ms, flash_n = sum(v[0] for v in hits), sum(v[1] for v in hits)
    if not flash_n:
        raise AssertionError(f"the profiler saw no {flash_symbol} launch")
    classes = {"matmul": ("gemm", "nvjet", "xmma", "cutlass", "sm90_"),
               "flash_attention": (flash_symbol,),
           "rmsnorm": ("rmsnorm_kernel",),
           "hash_partition_histogram": ("hash_hist_kernel",)}
    by_class = {c: sum(v[0] for k, v in by_name.items()
                       if any(t in k for t in subs)) for c, subs in classes.items()}
    by_class["other"] = busy_ms - sum(by_class.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    out = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_idle_share": 1.0 - busy_ms / wall_ms, "gpu_kernels": len(kernels),
           "device_ms_by_class": by_class,
           "flash_launches": flash_n, "flash_us_per_launch": 1e3 * flash_ms / flash_n,
           "top_kernels": [{"name": k[:80], "ms": v[0], "launches": v[1]}
                           for k, v in top]}
    return state, out


def phase_train(cfg):
    """The training path at full width: 20 steps with every counter zeroed
    just before and read just after, one profiled step, then a checkpoint
    round trip.  Returns the flash launches and device us per launch."""
    t_phase = time.perf_counter()
    run_cfg = RunConfig()
    state = init_train_state(torch.Generator(device="cuda").manual_seed(SEED), cfg,
                             run_cfg)
    step_fn = make_train_step(cfg, run_cfg)
    batches = corpus_batches(cfg, TRAIN_STEPS + 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    losses, norms, step_ms = [], [], []
    for batch in batches[:TRAIN_STEPS]:
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        losses.append(metrics["loss"].item())  # syncs: the step is done
        step_ms.append((time.perf_counter() - t0) * 1e3)
        norms.append(metrics["grad_norm"].item())
    launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if launches["flash_attention"] != 2 * cfg.num_layers * TRAIN_STEPS:
        raise AssertionError(f"flash launches {launches['flash_attention']}, "
                             f"expected {2 * cfg.num_layers} per step")
    others = {n: c for n, c in launches.items() if n not in PATH_KERNELS["train"]}
    if any(others.values()):
        raise AssertionError(f"the train path launched serving kernels: {others}")
    if not all(np.isfinite(losses + norms)):
        raise AssertionError(f"non-finite loss or grad-norm: {losses} {norms}")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    if not last < first:
        raise AssertionError(f"loss did not fall: first 5 {first}, last 5 {last}")
    steady = step_ms[1:]  # the first step also loads cuBLAS and the kernel
    out = {"phase": "train", "ok": True, "arch": cfg.name, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "param_dtype": str(cfg.param_dtype),
           "compute_dtype": str(cfg.compute_dtype), "optimizer": run_cfg.optimizer,
           "remat": run_cfg.remat, "batch": TRAIN_B, "seq": TRAIN_S,
           "steps": TRAIN_STEPS, "losses": losses, "grad_norms": norms,
           "first5_mean_loss": first, "last5_mean_loss": last,
           "first_step_ms": step_ms[0],
           "step_ms_p50": float(np.percentile(steady, 50)),
           "step_ms_p95": float(np.percentile(steady, 95)),
           "tokens_per_s": TRAIN_B * TRAIN_S * len(steady) / (sum(steady) / 1e3),
           "peak_memory_gb": peak_gb, "launches": launches,
           "flash_launches_per_step": launches["flash_attention"] / TRAIN_STEPS}

    state, prof = profile_train_step(step_fn, state, batches[TRAIN_STEPS])
    out["profile"] = prof

    # checkpoint round trip: snapshot + background write, then restore into
    # a fresh state, every leaf bitwise
    ckdir = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckdir, ignore_errors=True)
    t0 = time.perf_counter()
    ckpt = store.AsyncCheckpointer(str(ckdir), keep=1)
    ckpt.save(int(state["step"]), state)
    snapshot_s = time.perf_counter() - t0
    ckpt.close()
    save_s = time.perf_counter() - t0
    fresh = init_train_state(torch.Generator(device="cuda").manual_seed(SEED + 1),
                             cfg, run_cfg)
    t0 = time.perf_counter()
    restored = store.restore(str(ckdir), fresh)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    disk_bytes = sum(f.stat().st_size for f in ckdir.rglob("*") if f.is_file())
    shutil.rmtree(ckdir)
    leaves = list(zip(tree_leaves(state), tree_leaves(restored)))
    bad = [i for i, (a, b) in enumerate(leaves)
           if a.dtype != b.dtype or a.device != b.device or not torch.equal(a, b)]
    if bad:
        raise AssertionError(f"restored leaves differ: {bad}")
    out["checkpoint"] = {"leaves": len(leaves), "bitwise_equal": True,
                         "state_bytes": sum(a.numel() * a.element_size()
                                            for a, _ in leaves),
                         "disk_bytes": disk_bytes, "snapshot_s": snapshot_s,
                         "save_s": save_s, "restore_s": restore_s}
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    return launches["flash_attention"], prof["flash_us_per_launch"]


def phase_train_parity(cfg):
    """fp32 (TF32 off, set in main): PARITY_STEPS steps on the kernel path
    and on the plain path from one initial state and the same batches."""
    t_phase = time.perf_counter()
    run_cfg = RunConfig()
    batches = corpus_batches(cfg, PARITY_STEPS)
    runs = {}
    for impl in ("auto", "ref"):
        c = cfg.with_overrides(compute_dtype=torch.float32, decode_impl=impl)
        state = init_train_state(torch.Generator(device="cuda").manual_seed(SEED), c,
                                 run_cfg)
        step_fn = make_train_step(c, run_cfg)
        zero_counts()
        metrics = []
        for batch in batches:
            state, m = step_fn(state, batch)
            metrics.append({k: v.item() for k, v in m.items()})
        runs[impl] = {"metrics": metrics, "flash_launches": read_counts()["flash_attention"]}
        del state
        torch.cuda.empty_cache()
    if runs["auto"]["flash_launches"] != 2 * cfg.num_layers * PARITY_STEPS \
            or runs["ref"]["flash_launches"] != 0:
        raise AssertionError(f"flash launches: kernel path "
                             f"{runs['auto']['flash_launches']}, plain path "
                             f"{runs['ref']['flash_launches']}")
    rel = {k: max(abs(a[k] - b[k]) / abs(b[k]) for a, b in
                  zip(runs["auto"]["metrics"], runs["ref"]["metrics"]))
           for k in TRAIN_TOL}
    out = {"phase": "train_parity", "ok": all(rel[k] <= TRAIN_TOL[k] for k in TRAIN_TOL),
           "compute_dtype": "torch.float32", "tf32": False, "steps": PARITY_STEPS,
           "kernel_path": runs["auto"], "plain_path": runs["ref"],
           "max_rel_diff": rel, "tol_rel": TRAIN_TOL,
           "seconds": time.perf_counter() - t_phase}
    emit(out)
    if not out["ok"]:
        raise AssertionError("fp32 kernel and plain training paths disagree")


def flash_row(cfg, launches, device_us):
    """The flash kernel's timing row at the training shape, rotating over
    one input set per layer."""
    dt = cfg.compute_dtype
    B, S, H, KV, D = TRAIN_B, TRAIN_S, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    esz = torch.finfo(dt).bits // 8
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    cases = [flash_case(gen, B, H, KV, S, D, dt) for _ in range(cfg.num_layers)]
    err = max(check_flash(a)[0] for a in cases[:2])
    nxt = rotate(cases)
    ms = cuda_ms(lambda: fa.flash_attention_kernel(*nxt()))
    plain_ms = cuda_ms(lambda: fa.flash_attention_plain(*nxt()))
    lib = rotate([(q, k.repeat_interleave(H // KV, 1), v.repeat_interleave(H // KV, 1))
                  for q, k, v in cases])
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(*lib(), is_causal=True))
    bytes_ = esz * (2 * B * H * S * D + 2 * B * KV * S * D)  # q, out; k, v once
    flops = 4 * B * H * D * S * (S + 1) // 2                 # the causal triangle
    row = kernel_row("flash_attention", "src/repro/kernels/flash_attention.py:85",
                     launches, err, ms, plain_ms, bytes_, flops, lib_ms,
                     "SDPA (is_causal) with K/V pre-expanded to [B,H,S,D]",
                     {"B": B, "H": H, "KV": KV, "S": S, "D": D, "causal": True,
                      "layout": "[B,S,H,D] viewed as [B,H,S,D]", "dtype": str(dt)})
    redesigned(row, device_us)
    return row


def df_tables(mesh):
    """The dataframe phase's tables on the card, from numpy at SEED."""
    rng = np.random.default_rng(SEED)
    x1 = rng.standard_normal(DF_ROWS, dtype=np.float32)
    x2 = rng.standard_normal(DF_ROWS, dtype=np.float32)
    cols = {"k": rng.integers(0, DF_KEYS, DF_ROWS, dtype=np.int32),
            "v": rng.standard_normal(DF_ROWS, dtype=np.float32), "x1": x1, "x2": x2,
            "y": 3 * x1 - 2 * x2 + np.float32(0.1) * rng.standard_normal(
                DF_ROWS, dtype=np.float32)}
    rk = np.arange(DF_KEYS, dtype=np.int32)
    right = {"k": rk, "w": (10 * rk).astype(np.float32)}
    return (cols, Table.from_columns(cols, mesh),
            Table.from_columns(right, mesh))


def df_calls(t, r, impl):
    """The five operators, each returning (result, dropped)."""
    return {"shuffle": lambda: dfo.shuffle(t, "k", impl=impl),
            "sort": lambda: dfo.sort(t, "k"),
            "join": lambda: dfo.join(t, r, "k", impl=impl),
            "groupby": lambda: dfo.groupby_sum(t, "k", ["v"],
                                               groups_cap_per_shard=DF_GROUPS, impl=impl),
            "reduce": lambda: (dfo.reduce_sum(t, ["v"]), 0)}


def timed(call):
    """(result, dropped, ms by CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    res, dropped = call()
    end.record()
    end.synchronize()
    return res, dropped, start.elapsed_time(end)


def hash_u32_np(k):
    h = k.astype(np.uint32) * np.uint32(2654435761)  # wraps mod 2^32
    return h ^ (h >> np.uint32(16))


def check_df_on_host(cols, runs):
    """tests/spawn/dataframe_ops.py's checks at full size, in numpy."""
    keys, vals = cols["k"], cols["v"]
    counts = np.bincount(keys, minlength=DF_KEYS)
    checks = {}
    # shuffle: every row arrived, each key on the shard its hash names
    sh = runs["shuffle"][0]
    k, valid = sh.col("k").cpu().numpy(), sh.valid.cpu().numpy()
    shard = np.arange(len(k)) // (len(k) // DF_SHARDS)
    checks["shuffle"] = bool(
        np.array_equal(np.bincount(k[valid], minlength=DF_KEYS), counts)
        and np.array_equal(hash_u32_np(k[valid]) % DF_SHARDS, shard[valid]))
    # sort: every shard sorted, the shards in splitter order, every row there
    st = runs["sort"][0]
    k, valid = st.col("k").cpu().numpy(), st.valid.cpu().numpy()
    per = len(k) // DF_SHARDS
    segs = [k[i * per:(i + 1) * per][valid[i * per:(i + 1) * per]] for i in range(DF_SHARDS)]
    checks["sort"] = bool(
        all(np.all(np.diff(g) >= 0) for g in segs)
        and all(a.max() <= b.min() for a, b in zip(segs, segs[1:]) if len(a) and len(b))
        and np.array_equal(np.bincount(np.concatenate(segs), minlength=DF_KEYS), counts))
    # join: every left row matched, w == 10 k on each
    jn = runs["join"][0].to_numpy()
    checks["join"] = bool(len(jn["k"]) == DF_ROWS and np.array_equal(jn["w"], 10 * jn["k"]))
    # groupby: one slot per key, float64 sums and counts
    gb = runs["groupby"][0].to_numpy()
    want = np.bincount(keys, weights=vals.astype(np.float64), minlength=DF_KEYS)
    gb_err = float(np.abs(gb["v"] - want[gb["k"]]).max())
    checks["groupby"] = bool(
        len(np.unique(gb["k"])) == len(gb["k"]) == np.count_nonzero(counts)
        and np.array_equal(gb["_count"], counts[gb["k"]]) and gb_err <= DF_SUM_TOL)
    want_sum = float(vals.astype(np.float64).sum())
    reduce_rel = abs(runs["reduce"][0]["v"] - want_sum) / abs(want_sum)
    checks["reduce"] = bool(reduce_rel <= DF_SUM_TOL)
    return checks, {"groupby_max_abs_err": gb_err, "reduce_rel_err": reduce_rel}


def same_result(a, b, name):
    """Kernel run vs impl="ref" run of one operator: (equal, max abs
    difference of the groupby sums)."""
    (ra, da, _), (rb, db, _) = a, b
    if name == "reduce":
        return ra == rb and da == db, 0.0
    sums = ("v",) if name == "groupby" else ()
    ok = da == db and torch.equal(ra.valid, rb.valid) and ra.column_names == rb.column_names
    diff = 0.0
    for col in ra.column_names:
        if col in sums:
            diff = (ra.col(col) - rb.col(col)).abs().max().item()
            ok = ok and diff <= DF_PAIR_ATOL
        else:
            ok = ok and torch.equal(ra.col(col), rb.col(col))
    return ok, diff


def profiled_us(fn, symbols, reps: int = 10):
    """Device us per launch of each of ``symbols`` over ``reps`` runs of
    ``fn`` under torch.profiler (the device's own time, free of host
    dispatch)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    _, by_name = device_kernels(prof)
    out = {}
    for symbol in symbols:
        hits = [v for k, v in by_name.items() if symbol in k]
        ms, n = sum(v[0] for v in hits), sum(v[1] for v in hits)
        if not n:
            raise AssertionError(f"the profiler saw no {symbol} launch; it saw "
                                 f"{[k[:100] for k in by_name][:20]}")
        out[symbol] = 1e3 * ms / n
    return out


def top_kernels(fn, n: int = 6):
    """Where one run of ``fn`` spends its device time: the ``n`` kernels of
    most device ms under torch.profiler, or None when the window came back
    without device events (it informs section 5 of PERF.md; nothing is
    checked on it)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    _, by_name = device_kernels(prof)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:n]
    return [{"name": k[:90], "ms": v[0], "launches": v[1]} for k, v in top] or None


def profile_new_kernels():
    """Device us per launch of kernels 6 and 7 at their paths' shapes
    (rmsnorm on [4096, 2048] bf16; the hash on [8, 2^23] keys in
    [0, 2^20), 8 buckets), early in the run: windows opened after the
    dataframe and pipeline phases came back without device events."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    (x, w), = rms_cases(gen, 1)
    keys = torch.randint(0, DF_KEYS, (DF_SHARDS, DF_ROWS // DF_SHARDS), generator=gen,
                         device="cuda", dtype=torch.int32)
    (rms_symbol,), (hash_symbol,) = SYMBOLS["rmsnorm"], SYMBOLS["hash_partition_histogram"]
    return {"rmsnorm": profiled_us(lambda: rms.rmsnorm_kernel(x, w), (rms_symbol,))[rms_symbol],
            "hash_partition_histogram": profiled_us(
                lambda: hp.hash_partition_histogram_kernel(keys, num_buckets=DF_SHARDS),
                (hash_symbol,), reps=3)[hash_symbol]}


def phase_dataframe():
    """The dataframe path at 2^26 rows on 8 logical shards: every counter
    zeroed just before the kernel run and read just after; numpy checks;
    the impl="ref" run held to it.  Returns the host columns, the table
    and the hash launches."""
    t_phase = time.perf_counter()
    mesh = make_mesh((DF_SHARDS,), ("data",))
    t0 = time.perf_counter()
    cols, t, r = df_tables(mesh)
    setup_s = time.perf_counter() - t0
    table_gb = sum(c.numel() * c.element_size() for c in (*t.columns.values(), t.valid)) / 1e9
    for call in df_calls(t, r, "auto").values():  # warm-up: library, allocator
        call()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    counter = COUNTED["hash_partition_histogram"]
    runs, op_launches = {}, {}
    for name, call in df_calls(t, r, "auto").items():
        before = counter.launches
        runs[name] = timed(call)
        op_launches[name] = counter.launches - before
    launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if op_launches != DF_LAUNCHES or \
            launches["hash_partition_histogram"] != sum(DF_LAUNCHES.values()):
        raise AssertionError(f"hash launches {op_launches}, expected {DF_LAUNCHES}")
    others = {n: c for n, c in launches.items() if n not in PATH_KERNELS["dataframe"]}
    if any(others.values()):
        raise AssertionError(f"the dataframe path launched other kernels: {others}")
    dropped = {n: int(d) for n, (_, d, _) in runs.items()}
    if any(dropped.values()):
        raise AssertionError(f"rows dropped: {dropped}")
    checks, errs = check_df_on_host(cols, runs)
    if not all(checks.values()):
        raise AssertionError(f"dataframe results wrong: {checks} {errs}")
    pairs = {}
    ref_calls = df_calls(t, r, "ref")
    for name in runs:  # the plain histogram path, one operator at a time
        ok, diff = same_result(runs[name], timed(ref_calls[name]), name)
        pairs[name] = {"equal": ok, "groupby_sum_max_abs_diff": diff}
        if not ok:
            raise AssertionError(f"{name}: kernel and impl='ref' runs differ: {pairs[name]}")
    if read_counts()["hash_partition_histogram"] != launches["hash_partition_histogram"]:
        raise AssertionError("the impl='ref' run launched the hash kernel")
    calls = df_calls(t, r, "auto")
    breakdown = {name: top_kernels(calls[name]) for name in ("shuffle", "sort", "groupby")}
    emit({"phase": "dataframe", "ok": True, "gpu": gpu_line(), "rows": DF_ROWS,
          "right_rows": DF_KEYS, "shards": DF_SHARDS, "table_gb": table_gb,
          "setup_s": setup_s,
          "ops": {n: {"ms": ms, "rows_per_s": DF_ROWS / (ms / 1e3), "dropped": d,
                      "hash_launches": op_launches[n], "host_check": checks[n]}
                  for n, (_, d, ms) in runs.items()},
          "host_errors": errs, "launches": launches, "peak_memory_gb": peak_gb,
          "ref_run": pairs, "top_kernels": breakdown,
          "ref_tolerance": (f"groupby sums {DF_PAIR_ATOL} abs: float32 index_add_ "
                            "adds with atomics in a run-dependent order; all else "
                            "bitwise"),
          "seconds": time.perf_counter() - t_phase})
    del runs
    return cols, t, launches["hash_partition_histogram"]


def phase_pipeline(t, host_cols):
    """tests/test_system.py's pipeline without the pilot, at 2^26 rows:
    filter, the zero-copy loader (shuffled), SGD on a linear model,
    postprocess; then the host prefetcher over host batches."""
    t_phase = time.perf_counter()
    cols, valid = filter_rows(t.columns, t.valid, t.col("x1").abs() < 3.0)
    table = t.with_columns({c: cols[c] for c in ("x1", "x2", "y")}, valid)
    loader = ZeroCopyLoader(table, ["x1", "x2"], "y", PIPE_BATCH, shuffle=True,
                            seed=SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batches = sum(1 for _ in loader.epoch(0))
    torch.cuda.synchronize()
    loader_s = time.perf_counter() - t0

    w = torch.zeros(2, device="cuda", requires_grad=True)
    b = torch.zeros((), device="cuda", requires_grad=True)
    losses, epoch = [], 1
    t0 = time.perf_counter()
    while len(losses) < PIPE_STEPS:
        for feats, labels, mask in loader.epoch(epoch):
            err = torch.where(mask, feats @ w + b - labels, 0.0)
            loss = (err ** 2).sum() / mask.sum().clamp(min=1)
            gw, gb = torch.autograd.grad(loss, (w, b))
            with torch.no_grad():
                w -= 0.1 * gw
                b -= 0.1 * gb
            losses.append(loss.detach())
            if len(losses) == PIPE_STEPS:
                break
        epoch += 1
    losses = torch.stack(losses).tolist()  # the one host sync of the loop
    train_s = time.perf_counter() - t0
    w_err = float((w.detach().cpu() - torch.tensor([3.0, -2.0])).abs().max())
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    if not (w_err < 0.2 and last < first and np.isfinite(losses).all()):
        raise AssertionError(f"pipeline did not learn: w_err {w_err}, loss {first} -> {last}")

    # host -> device: 16 batches of four 2^22-row host columns (64 MB each)
    step = DF_ROWS // 16
    host = [tuple(host_cols[c][i:i + step] for c in ("x1", "x2", "y", "v"))
            for i in range(0, DF_ROWS, step)]
    nbytes = sum(a.nbytes for item in host for a in item)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = list(HostPrefetcher(iter(host), depth=2))
    torch.cuda.synchronize()
    prefetch_s = time.perf_counter() - t0
    if not all(torch.equal(d, torch.from_numpy(h).cuda())
               for item, dev in zip(host, got) for h, d in zip(item, dev)) \
            or len(got) != len(host):
        raise AssertionError("prefetched batches differ from the host batches")
    emit({"phase": "pipeline", "ok": True, "gpu": gpu_line(), "rows": DF_ROWS,
          "valid_rows": int(valid.sum()), "global_batch": PIPE_BATCH,
          "loader_batches": batches, "loader_s": loader_s,
          "loader_rows_per_s": batches * PIPE_BATCH / loader_s,
          "train_steps": PIPE_STEPS, "train_s": train_s,
          "train_steps_per_s": PIPE_STEPS / train_s,
          "first10_mean_loss": first, "last10_mean_loss": last,
          "w": w.detach().cpu().tolist(), "b": float(b.detach()), "w_err": w_err,
          "prefetch_batches": len(got), "prefetch_bytes": nbytes,
          "prefetch_s": prefetch_s, "prefetch_gb_per_s": nbytes / prefetch_s / 1e9,
          "seconds": time.perf_counter() - t_phase})


def rms_cases(gen, n):
    """n (x, w) pairs at the training activations' shape, bf16."""
    return [(randn(gen, RMS_SHAPE, torch.bfloat16),
             randn(gen, RMS_SHAPE[-1:], torch.bfloat16)) for _ in range(n)]


def phase_rmsnorm(cfg):
    """The fused norm's only entry point, ``ops.rmsnorm``, once per layer on
    bf16 training activations, counters zeroed just before and read just
    after."""
    cases = rms_cases(torch.Generator(device="cuda").manual_seed(SEED + 4),
                      cfg.num_layers)
    torch.cuda.synchronize()
    zero_counts()
    outs = [ops.rmsnorm(x, w) for x, w in cases]
    torch.cuda.synchronize()
    launches = read_counts()
    if launches["rmsnorm"] != cfg.num_layers or any(
            c for n, c in launches.items() if n not in PATH_KERNELS["rmsnorm"]):
        raise AssertionError(f"ops.rmsnorm launches {launches}, expected "
                             f"{cfg.num_layers} of rmsnorm alone")
    if not all(o.shape == x.shape and o.dtype == x.dtype and bool(o.isfinite().all())
               for o, (x, _) in zip(outs, cases)):
        raise AssertionError("ops.rmsnorm output of the wrong shape or not finite")
    emit({"phase": "rmsnorm", "ok": True, "calls": len(cases), "shape": list(RMS_SHAPE),
          "dtype": "torch.bfloat16", "launches": launches})
    return launches["rmsnorm"]


def rmsnorm_row(launches, device_us):
    """Kernel 6 at the training activations' shape, rotating over four
    input sets (134 MB with the outputs, past the 50 MB L2)."""
    cases = rms_cases(torch.Generator(device="cuda").manual_seed(SEED + 5), 4)
    err = max((rms.rmsnorm_kernel(x, w).float() - rms.rmsnorm_plain(x, w).float())
              .abs().max().item() for x, w in cases[:2])
    nxt = rotate(cases)
    ms = cuda_ms(lambda: rms.rmsnorm_kernel(*nxt()))
    plain_ms = cuda_ms(lambda: rms.rmsnorm_plain(*nxt()))
    d = RMS_SHAPE[-1]

    def library():
        x, w = nxt()
        return F.rms_norm(x, (d,), w, eps=1e-5)

    lib_ms = cuda_ms(library)
    rows, esz = RMS_SHAPE[0], 2
    row = kernel_row("rmsnorm", "src/repro/kernels/rmsnorm.py:24", launches, err, ms,
                     plain_ms, 2 * rows * d * esz + d * esz, 4 * rows * d, lib_ms,
                     "torch.nn.functional.rms_norm (weight w, eps 1e-5), timed "
                     "only: the port never calls it",
                     {"x": list(RMS_SHAPE), "dtype": "torch.bfloat16", "w": [d]},
                     flops_per_s=FP32_FLOPS_PER_S)
    row["device_us_per_launch"] = device_us
    return row


def hash_row(launches, device_us):
    """Kernel 7 at the dataframe path's launch: [8, 2^23] int32 keys in
    [0, 2^20), 8 buckets, blocks of 2048 (two key sets of 268 MB)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    cases = [torch.randint(0, DF_KEYS, (DF_SHARDS, DF_ROWS // DF_SHARDS), generator=gen,
                           device="cuda", dtype=torch.int32) for _ in range(2)]
    hist = [hp.hash_partition_histogram_kernel(k, num_buckets=DF_SHARDS) for k in cases]
    if not all(torch.equal(h, hp.hash_partition_histogram_plain(k, num_buckets=DF_SHARDS))
               for h, k in zip(hist, cases)):
        raise AssertionError("hash kernel disagrees with its plain version at the path's shape")
    nxt = rotate(cases)
    ms = cuda_ms(lambda: hp.hash_partition_histogram_kernel(nxt(), num_buckets=DF_SHARDS))
    plain_ms = cuda_ms(lambda: hp.hash_partition_histogram_plain(nxt(), num_buckets=DF_SHARDS),
                       iters=10)
    row = kernel_row("hash_partition_histogram", "src/repro/kernels/hash_partition.py:42",
                     launches, 0.0, ms, plain_ms, 4 * DF_ROWS + 4 * hist[0].numel(), 0,
                     None, "no single PyTorch call computes per-block histograms of "
                     "this hash (the plain version is a hash, a pad and a scatter_add_)",
                     {"keys": [DF_SHARDS, DF_ROWS // DF_SHARDS], "dtype": "torch.int32",
                      "buckets": DF_SHARDS, "block": 2048,
                      "ops_bound": "integer ops (~6 per key) not counted: bytes bound it"},
                     source="hash_partition")
    row["device_us_per_launch"] = device_us
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 means fp32
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    phase_kernels()
    new_us = profile_new_kernels()
    cfg = get_config(ARCH)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = init_params(gen, model_specs(cfg), "cuda")
    launches, shapes = {}, None
    for layout in LAYOUTS:
        serve, layout_shapes = phase_serve(cfg, params, layout)
        launches.update({n: serve["launches"][n] for n in PATH_KERNELS[layout]})
        shapes = shapes or layout_shapes  # the paged run's buckets
    rows = phase_timing(cfg, launches, shapes)
    device_us = {}
    for layout in LAYOUTS:
        device_us.update(phase_profile(cfg, params, layout))
    for row in rows:  # the paged prefill's is taken at its timing shape
        row.setdefault("device_us_per_launch", device_us[row["name"]])
    phase_stream(cfg, params)
    del params
    torch.cuda.empty_cache()
    flash_launches, flash_us = phase_train(cfg)
    torch.cuda.empty_cache()
    phase_train_parity(cfg)
    rows.append(flash_row(cfg, {"flash_attention": flash_launches}, flash_us))
    torch.cuda.empty_cache()
    host_cols, table, hash_launches = phase_dataframe()
    phase_pipeline(table, host_cols)
    del table, host_cols
    torch.cuda.empty_cache()
    rows.append(rmsnorm_row({"rmsnorm": phase_rmsnorm(cfg)}, new_us["rmsnorm"]))
    rows.append(hash_row({"hash_partition_histogram": hash_launches},
                         new_us["hash_partition_histogram"]))
    emit({"phase": "timing", "ok": True, "rows": rows[-3:]})
    print(gpu_line(), flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
