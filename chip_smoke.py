#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py
    python3 chip_smoke.py --compare 3 [--src OTHER_CHECKOUT/src]

The second form builds the kernels, runs only the serve phase's rounds
(3 rounds of both layouts in turn) and times the serving kernels'
wrappers at the serving shape, both decodes also in fp32
(``compare_kernels``); --src drives another checkout's package with this
script.  Run parent, change, change, parent in one call to compare two
trees on one card.

Phases, each printing one JSON line per layout or run; any failure exits
non-zero:

1. build    compile ``src/repro_torch/kernels/csrc/*.cu`` with nvcc for
            sm_90a (one nvcc per source, all at once) into build/kernels/;
            count the tensor-core instructions (HMMA for mma.sync, HGMMA
            for wgmma) in the SASS of the four serving libraries redesigned
            for the tensor cores (cuobjdump).
2. kernels  each of the seven kernels against its plain PyTorch version on
            the card.  The five attention kernels at full tinyllama-1.1b
            shapes and at the smoke shapes, fp32 and bf16: ragged, empty,
            full and past-the-end lengths, a scalar length, a window, an S
            that is not a power of two, sentinel table entries,
            page-straddling chunks, inert rows and chunks whose tokens run
            past the end of the cache; flash attention causal and full at
            the training shape, an S that is not a multiple of the tile,
            S = 1, D 16 and 128, and G = 1.  Both decodes and both
            prefills at the shapes tinyllama-1.1b's serving path gives
            them (``serving_shape_cases``: get_config and the serve
            engine's settings).  Head dim 96 (phi3-mini) in all five
            attention kernels at KV 2, G 1 and 8: flash causal and full,
            both prefills and both decodes with ragged lengths.  rmsnorm at [4096, 2048],
            [4, 17, 256] and [1, 5120] in fp32 and bf16 (RMS_TOL); the
            hash-partition histogram bitwise at n 1, 2047, 2048, 2049 and
            2^23 keys (negatives and the int32 extremes among them) for 4,
            8, 16, 64 and 4096 buckets.  The five kernels redesigned for
            the tensor cores also over sweeps: flash attention at S 1, 63,
            64, 65, 127, 512 and 1000, D 16 to 128, G 1 and 8, causal and
            full; both prefills at chunks of 1 to 64 tokens, bases 0 to
            500; the contiguous decode at lengths 0 to S + 5 across the
            16-key tile, windows 0, 8, 64 and 100 and a scalar length, G 1
            to 32, D 16 to 128, S 32, 512 (one launch) and 4096 (the
            combine pass), and bf16 off the 16-byte boundary (the CUDA-core
            body); the paged decode at pages of 8, 16, 64 and 128, rows of
            one page, 512 positions (one launch) and 4096 (the combine
            pass), lengths across the tile and page edges, S - 1, S and
            past it, windows 0, 1, 100 and past every length, a scalar
            length, G 1 to 32, D 16 to 128, sentinels in every table, and
            bf16 off the 16-byte boundary.  The paged cache scatter bitwise against the plain one
            on tests/paged_scatter_cases.py; both prefill wrappers, both
            decodes and the decode append once under sync-debug "error" (a
            host sync fails the phase).  Last, on draws after all the
            others (theirs stay the parent commit's), the contiguous decode
            at head dim 24 (minicpm3's smoke MLA decode) at its serving
            shapes and over the contiguous sweep's S, G, lengths and
            windows, and the paged prefill at the widths the fleet's
            prefill-only engines give it (tinyllama's H, KV, D; B 8, T 128,
            256 and 512 at base 0, ragged chunk lengths across page and
            tile edges, an empty row).  Each element of a kernel's output is
            held to its plain version within 1e-4 (fp32) or the larger of
            2e-2 and one bf16 ulp of the plain value (bf16; TOL_NOTE).
            Then torch.profiler's device time
            per launch of rmsnorm and the hash at their paths' shapes
            (taken here: windows opened late in the run came back without
            device events).
3. serve    full-width tinyllama-1.1b (random weights from a seeded
            torch.Generator, bf16 compute) serves 16 greedy requests shaped
            like the repo's mixed workload through ``submit`` +
            ``run_until_drained`` on the paged KV cache and on the
            contiguous slot cache, SERVE_ROUNDS rounds of both layouts in
            turn; one line per run, then each layout's tokens/s, TTFT p50
            and step p50 per round with their median, min and max.  Every
            launch counter is zeroed just before each run and read just
            after: the layout's two kernels (and on the paged layout the
            cache scatter, once per prefill call and decode append) must
            have launched, no other kernel may have.
4. timing   each kernel's wrapper at the shapes of its path against its
            plain version and a PyTorch SDPA yardstick (CUDA events), with
            its roofline bound and SDPA's device time per call
            (torch.profiler); for both prefills and both decodes also the
            device time of their kernels, for the paged prefill the
            scatter kernel alone, for both decodes also their fp32 call
            (the CUDA-core body) at the same shape.
5. profile  torch.profiler over a separate serving run per layout: device
            busy and idle share, kernels and host ops per engine step, the
            port's kernels' device time per launch, top kernels; neither
            layout may launch a combine pass.
6. stream   the same engines in fp32: on each layout the kernel path and
            the plain path, and the two layouts' kernel paths, must emit
            token-identical greedy streams.
   sampling seeded sampling on full-width tinyllama-1.1b: the threefry
            split keys, random bits and uniforms of 64 seeds (half >= 2^32)
            over the vocabulary, computed on the card, bitwise against a
            numpy threefry written in this script; on an fp32 paged engine
            one seed twice gives one stream, another seed another, top_k=1
            equals greedy, and a stream checkpointed, released and restored
            mid-decode resumes the uninterrupted one; then the serve
            phase's 16 requests greedy and sampled (temperature 1), their
            tokens/s side by side, and a profile of a window of
            PROFILE_WINDOW decode steps of each (the profile phase's line).
   fleet    the serving fleet (``serve.build_fleet``, ``EngineRouter``) on
            full-width tinyllama-1.1b, two engines of the serve settings
            sharing its weights (phase_fleet): in fp32, a disaggregated
            1 + 1 fleet (a prefill-only engine handing KV pages to a
            decode engine), a colocated fleet of 2 through a rolling
            restart, and one through an injected engine crash under a
            FailurePolicy (eject, probe, re-admit), each serving
            FLEET_REQUESTS requests with every greedy stream equal to one
            colocated paged engine's; the disaggregated run's counters
            zeroed just before and read just after: only the paged kernels,
            kernel 5 exactly 22 x the prefill engine's chunks, kernel 3
            exactly 22 x the decode engine's steps, the handoffs exactly
            the owned pages.  Then bf16 tokens/s, TTFT p50 and handoff ms
            a request of FLEET_RATE_REQUESTS requests through the colocated
            and the disaggregated fleet, FLEET_ROUNDS rounds each (medians,
            min, max); ``launch.serve.run --fleet 2 --disaggregate``; and
            kernel 5 timed at the fleet's prefill widths (fleet_prefill_rows).
   phi3     phi3-mini-3.8b at its published widths (32 layers, d_model
            3072, 32 heads, 32 KV heads, head_dim 96, d_ff 8192, vocab
            32064): first both decodes and both prefills against their
            plain versions at the shapes its serving path gives them (B 8,
            H 32, KV 32, D 96, S 512, T 64, page 16; fp32 and bf16,
            ``serving_shape_cases``); then, tinyllama's parameters freed,
            random weights from a seeded torch.Generator and bf16 compute,
            it serves 4 greedy requests of the mixed workload on each KV
            layout, on the serve phase's engine settings; counters as in
            the serve phase: the layout's kernels launched, no other.
   mla_moe  minicpm3-4b (MLA) at its published widths (62 layers,
            d_model 2560, 40 heads padded to 48, q_lora 768, kv_lora 256,
            nope 64, rope 32, v 64, vocab 73448; fp32 parameters, 4.40 B)
            and then moonshot-v1-16b-a3b (MoE) at its (48 layers, d_model
            2048, 16 heads, head_dim 128, 64 experts top-6, d_ff 1408, the
            first layer dense with d_ff 11264, vocab 163840; bf16
            parameters, 27.57 B, 55.1 GB), each freed before the next
            loads: the kernels its serving path reaches held against their
            plain versions at the shapes the path gives them, fp32 and
            bf16 (serving_shape_cases: MLA the contiguous decode alone at
            H 48, KV 48, D 96; moonshot all four at H 16, KV 16, D 128);
            4 greedy requests per layout, counters zeroed just before and
            read just after each run: the path's kernels launched and no
            other (MLA: the contiguous decode alone, on either layout);
            minicpm3's fp32 streams, kernel path against plain path, token
            for token (the stream phase's checks); a profile of a window of
            PROFILE_WINDOW paged decode steps each (the profile phase's
            line).  Then kernel 2 timed at
            the MLA serving shape and kernels 3 and 5 at moonshot's, in the
            timing rows' format with SDPA beside (each row's
            ``at_other_shapes``).
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
   runtime  the two main paths through the port's pilot runtime.  The
            training entry point ``repro_torch.launch.train.run``: its stage
            graph (preprocess >> train >> postprocess) under a Session over
            the card, full-width tinyllama-1.1b, B 8 x S 512, RUNTIME_STEPS
            steps, its checkpoint written to a temporary directory removed
            afterwards.  Counters zeroed just before and read just after:
            flash attention exactly 44 launches a step, no other kernel;
            the loss falls (postprocess ``improved``); the train stage's
            overheads (queue, communicator, execute) and placement are
            printed.  Then a paged fp32 ServeEngine on the serve phase's
            settings as a service stage (``session.serve``):
            RUNTIME_REQUESTS greedy requests through the ServiceHandle,
            then drain; every request's tokens equal the same engine's
            ``run_until_drained`` on the same weights, and only the paged
            decode, the paged prefill and the scatter launch.  Rows 1, 3
            and 5 of the kernel table count these launches too.
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
10. pipeline  the paper's preprocess -> bridge -> train -> postprocess as
            a Pipeline of a cylon_stage and two dl_stages under the port's
            run_pipelines on a pilot over the card: filter |x1| < 3 on that
            table, a shuffled ZeroCopyLoader (data_bridge) at global batch
            65536, PIPE_STEPS SGD steps of a linear model (w_err < 0.2,
            loss falling), then HostPrefetcher over host batches (arrive
            equal; GB/s).
11. rmsnorm   the fused norm's entry point ``ops.rmsnorm`` on [4096, 2048]
            bf16 activations once per tinyllama layer (22 launches, counted
            as above); then the timing rows of kernels 6 and 7.
12. paper   the paper's tables (``repro_torch.launch.paper_tables``) at
            the JAX package's default sizes, on the card under a
            PilotManager over torch.cuda: Table 3 (the 11 forecasting
            models, 60 SGD steps each, bare-metal and as a RemoteAgent
            task: train seconds, Deep RC total, overhead, MAE, MSE, MAPE),
            Tables 1-2 (the hydrology LSTM, 150 steps on 2000 days:
            per-target train and validation MSE and NNSE, the overhead
            decomposition), Table 4 (11 pipelines of a cylon_stage sort and
            a dl_stage inference against sequential: bm_s, rc_s, saved_s).
            Every task DONE, every metric finite, validation NNSE above 0.5
            for mean_temperature and streamflow, no port kernel launched.
            The seeded draws are JAX's: ``make_ett_series`` on the card
            against a numpy reference from threefry_np's bits (ETT_TOL).
            Then torch.profiler over PAPER_PROFILE_STEPS SGD steps of the
            GRU and of the LSTM: device idle share, kernels per step.

Each phase's wall seconds are printed on one line (``"phase": "wall"``).

The last lines are the card (nvidia-smi name and power limit), the kernel
table ``{"kernels": [...]}`` and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import itertools
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent


def parse_args(argv):
    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch port on one GPU.")
    ap.add_argument("--compare", type=int, default=0, metavar="R",
                    help="run only R rounds of the serve phase on both layouts "
                         "and time the serving kernels' wrappers")
    ap.add_argument("--src", type=Path, default=ROOT / "src",
                    help="the package to drive (another checkout's src/)")
    return ap.parse_args(argv)


ARGS = parse_args(sys.argv[1:])
sys.path.insert(0, str(ARGS.src.resolve()))
sys.path.insert(0, str(ROOT / "tests"))  # the scatter's edge cases

from repro_torch.bridge.loader import HostPrefetcher  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.common.params import Param, init_params, map_tree, tree_leaves  # noqa: E402
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
from repro_torch.serve import Request, RequestState, ServeEngine  # noqa: E402
from repro_torch.train.state import init_train_state, model_specs  # noqa: E402
from repro_torch.train.step import make_prefill_chunk_step, make_train_step  # noqa: E402
import paged_scatter_cases  # noqa: E402

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
BF16_FLOPS_PER_S = 989e12     # H100 SXM dense bf16 tensor-core peak
FP32_FLOPS_PER_S = 67e12      # H100 SXM fp32 outside the tensor cores
# kernel vs plain, per element: fp32 sums in another order (~1e-6 seen),
# 1e-4; bf16 outputs may round one bf16 ulp of the plain value apart, so
# max(2e-2, that ulp) (2e-2 below |x| = 4, one ulp at and above it)
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
TOL_NOTE = {torch.float32: "1e-4", torch.bfloat16: "max(2e-2, 1 bf16 ulp of |plain|)"}
ARCH = "tinyllama-1.1b"
# the second dense config, at full width: head dim 96, G 1
PHI3, PHI3_REQUESTS = "phi3-mini-3.8b", 4
# the MLA and the MoE config, at full width, and the requests each serves
# per layout; moonshot's parameters are bf16 (fp32 would be 110 GB)
MLA, MOE, MLA_MOE_REQUESTS = "minicpm3-4b", "moonshot-v1-16b-a3b", 4
MOE_PARAM_DTYPE = torch.bfloat16
# the sampling phase: seeds of the threefry check (64, half >= 2^32), and
# the temperature of the sampled serving run
SAMPLE_SEEDS, SAMPLE_TEMPERATURE = 64, 1.0
# engine steps of the decode windows the sampling and mla_moe phases profile
PROFILE_WINDOW = 4
# the fleet phase: requests of its stream checks (fp32), of its rate runs
# (bf16) and rounds of those; the chunk widths a prefill-only engine gives
# kernel 5 (whole prompts up to max_len), checked and timed at B 8
FLEET_REQUESTS, FLEET_RATE_REQUESTS, FLEET_ROUNDS = 8, 16, 3
FLEET_T = (128, 256, 512)
PAGE = 16
MAX_LEN = 512
# the serve engine's settings, for every served config; the kernels are
# checked at the shapes they give (serving_shape_cases)
SERVE = {"max_slots": 8, "max_len": MAX_LEN, "page_size": PAGE,
         "prefill_chunk_tokens": 64}
# rounds of the serve phase per layout: tokens/s is read as a median and
# a spread, never from one run
SERVE_ROUNDS = 3
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
# kernels 1, 2, 4 and 5 are flash_fwd_kernel, contig_decode_split_kernel,
# contig_prefill_kernel and prefill_kernel; the paged decode's fp32 body
# is decode_split_kernel); neither decode launches a combine pass at
# S <= 512
SYMBOLS = {"decode_attention_paged": ("paged_decode_mma_kernel",),
           "prefill_attention_paged": ("prefill_paged_wgmma_kernel",),
           "paged_scatter": ("paged_scatter_kernel",),
           "decode_attention": ("contig_decode_mma_kernel",),
           "prefill_attention": ("chunk_scatter_kernel", "contig_prefill_wgmma_kernel"),
           "flash_attention": ("flash_fwd_wgmma_kernel",),
           "rmsnorm": ("rmsnorm_kernel",),
           "hash_partition_histogram": ("hash_hist_kernel",)}
# the libraries of the serving kernels redesigned for the tensor cores,
# and the instruction their SASS must hold (HMMA: mma.sync; HGMMA: wgmma)
TC_SASS = {"decode_attention": "HMMA", "decode_attention_paged": "HMMA",
           "prefill_attention": "HGMMA", "prefill_attention_paged": "HGMMA"}
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
# the standardized ETT series on the card against its numpy reference
# (the repo's parity limit for it against JAX's)
ETT_TOL = 1e-5
# groupby sums, kernel run vs impl="ref" run (absolute): the same float32
# sums of ~64 values in another order (index_add_ adds with atomics)
DF_PAIR_ATOL = 1e-4
PIPE_BATCH, PIPE_STEPS = 65536, 1024
# the runtime phase: the training entry point's stage graph for RUNTIME_STEPS
# steps of B x S tokens (TRAIN_B, TRAIN_S), then RUNTIME_REQUESTS greedy
# requests through a service stage
RUNTIME_STEPS, RUNTIME_REQUESTS = 10, 4
# the paper phase: validation NNSE above 0.5 (NSE > 0, better than the
# mean) for these hydrology targets; steps of the profiled windows
NNSE_TARGETS, PAPER_PROFILE_STEPS = ("mean_temperature", "streamflow"), 5


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


def paged_pool(gen, B, KV, D, max_pages, lens, dtype, page=PAGE):
    """Pools with spare pages and a scrambled table giving each row exactly
    the pages ``lens`` need (at most max_pages); every other entry is a
    sentinel (>= num_pages)."""
    need = [min(-(-max(int(n), 0) // page), max_pages) for n in lens]
    num_pages = sum(need) + 3
    ids = torch.randperm(num_pages, generator=gen, device="cuda").tolist()
    bt = torch.full((B, max_pages), num_pages, dtype=torch.int32)
    for b, n in enumerate(need):
        bt[b, :n] = torch.tensor(ids[:n], dtype=torch.int32)
        bt[b, n:] += b  # sentinels past num_pages too
        ids = ids[n:]
    kp = randn(gen, (num_pages, page, KV, D), dtype)
    vp = randn(gen, (num_pages, page, KV, D), dtype)
    return kp, vp, bt.cuda()


def i32(x):
    return torch.tensor(x, dtype=torch.int32, device="cuda")


def decode_case(gen, H, KV, D, max_pages, lens, dtype, page=PAGE):
    B = len(lens)
    kp, vp, bt = paged_pool(gen, B, KV, D, max_pages, lens, dtype, page)
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


def elem_limit(want: torch.Tensor) -> torch.Tensor:
    """Each element's limit against the plain value ``want``: TOL for
    fp32; for bf16 the larger of 2e-2 and one bf16 ulp of |want|
    (2^(e - 8) for |want| = m 2^e, m in [0.5, 1))."""
    if want.dtype != torch.bfloat16:
        return torch.full_like(want, TOL[want.dtype], dtype=torch.float32)
    _, e = torch.frexp(want.float().abs())
    return torch.clamp(torch.ldexp(torch.ones_like(e, dtype=torch.float32), e - 8),
                       min=TOL[torch.bfloat16])


def vs_plain(got: torch.Tensor, want: torch.Tensor):
    """(max abs error, every element within elem_limit of the plain)."""
    diff = (got.float() - want.float()).abs()
    return diff.max().item(), bool((diff <= elem_limit(want)).all())


def check_contig_decode(args, window=0):
    """(max abs error vs plain, every element within its limit and empty
    rows exactly zero)."""
    got = dec.decode_attention_kernel(*args, window=window)
    want = dec.decode_attention_plain(*args, window=window)
    empty = args[3].expand(got.shape[0]) == 0
    err, within = vs_plain(got, want)
    return err, within and bool((got[empty] == 0).all())


def check_contig_prefill(args):
    """(max abs error vs plain, every element within its limit, caches
    equal and padding rows exactly zero); each side writes its own copy
    of the caches."""
    q, kn, vn, kc, vc, base, clens = args
    got, gk, gv = pf.prefill_attention_kernel(q, kn, vn, kc.clone(), vc.clone(),
                                              base, clens)
    want, wk, wv = pf.prefill_attention_plain(q, kn, vn, kc.clone(), vc.clone(),
                                              base, clens)
    pad = torch.arange(q.shape[1], device="cuda")[None, :] >= clens[:, None]
    err, within = vs_plain(got, want)
    return err, (within and torch.equal(gk, wk) and torch.equal(gv, wv)
                 and bool((got[pad] == 0).all()))


def check_decode(args, window=0):
    """(max abs error vs plain, every element within its limit and empty
    rows exactly zero)."""
    got = dec.decode_attention_paged_kernel(*args, window=window)
    want = dec.decode_attention_paged_plain(*args, window=window)
    empty = args[4].expand(got.shape[0]) == 0
    err, within = vs_plain(got, want)
    return err, within and bool((got[empty] == 0).all())


def check_prefill(args):
    """(max abs error vs plain, every element within its limit, pools
    equal and padding rows exactly zero); each side writes its own copy
    of the pools."""
    q, kn, vn, kp, vp, bt, base, clens = args
    got, gk, gv = pf.prefill_attention_paged_kernel(
        q, kn, vn, kp.clone(), vp.clone(), bt, base, clens)
    want, wk, wv = pf.prefill_attention_paged_plain(
        q, kn, vn, kp.clone(), vp.clone(), bt, base, clens)
    pad = torch.arange(q.shape[1], device="cuda")[None, :] >= clens[:, None]
    err, within = vs_plain(got, want)
    return err, (within and torch.equal(gk, wk) and torch.equal(gv, wv)
                 and bool((got[pad] == 0).all()))


def flash_case(gen, B, H, KV, S, D, dtype):
    """q, k, v as the model hands them over: [B, S, heads, D] activations
    viewed as [B, heads, S, D]."""
    return tuple(randn(gen, (B, S, n, D), dtype).transpose(1, 2)
                 for n in (H, KV, KV))


def check_flash(args, causal=True):
    """(max abs error vs plain, every element within its limit and the
    output shaped and typed like q)."""
    got = fa.flash_attention_kernel(*args, causal=causal)
    want = fa.flash_attention_plain(*args, causal=causal)
    err, within = vs_plain(got, want)
    return err, within and got.shape == args[0].shape and got.dtype == args[0].dtype


# -- phases ------------------------------------------------------------------


def tc_instructions(name: str, opcode: str) -> int:
    """Instructions of ``opcode`` in the SASS of library ``name``."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(build.library_path(name))],
                          check=True, capture_output=True, text=True).stdout
    return sum(1 for ln in sass.splitlines() if f" {opcode}." in ln)


def phase_build():
    t0 = time.perf_counter()
    logs = build.build_all()
    secs = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if any(w in ln for w in ("entry function", "registers", "spill"))]
             for name, log in logs.items()}
    sass = {name: {opcode: tc_instructions(name, opcode)}
            for name, opcode in TC_SASS.items()}
    if not all(n for counts in sass.values() for n in counts.values()):
        raise AssertionError(f"a redesigned kernel has no tensor-core instruction: {sass}")
    emit({"phase": "build", "ok": True, "seconds": secs, "gpu": gpu_line(),
          "nvcc": " ".join(build.NVCC_FLAGS), "ptxas": ptxas,
          "tensor_core_sass": sass})


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
                          "tol": TOL_NOTE[dtype], "ok": ok})
            if not ok:
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
                          "tol": TOL_NOTE[dtype], "ok": ok})
            if not ok:
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
                              "max_abs_err": err, "tol": TOL_NOTE[dtype],
                              "ok": ok})
                if not ok:
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
                          "tol": TOL_NOTE[dtype], "ok": ok})
            if not ok:
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
                              "max_abs_err": err, "tol": TOL_NOTE[dtype],
                              "ok": ok})
                if not ok:
                    raise AssertionError(f"flash kernel disagrees: {cases[-1]}")
        cases += serving_shape_cases(gen, ARCH, dtype)
        cases += head_dim_96_cases(gen, dtype)
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
    cases += head_dim_24_cases(gen)
    cases += fleet_prefill_cases(gen)
    emit({"phase": "kernels", "ok": True, "kernels": list(COUNTED),
          "cases": cases})


def fleet_chunk_lens(T, B):
    """A prefill-only engine's chunk of width T: whole prompts at base 0 --
    a full row, one a token short, rows across the middle page and 64-row
    tile edges, 65 and 17 tokens (just past a tile and a page), one token
    and an empty row."""
    return ([T, T - 1, T // 2 + 1, T // 2 - 1, 65, 17, 1, 0] * B)[:B]


def fleet_prefill_cases(gen):
    """Kernel 5 at the widths the fleet's prefill-only engines give it
    (tinyllama-1.1b's H, KV, D; the serve engine's B 8, max_len 512, page
    16; T 128, 256, 512, base 0, fleet_chunk_lens), fp32 and bf16: pools
    bitwise, padding and the empty row exactly zero.  Drawn after every
    other case of the phase, whose inputs stay those of the parent."""
    from repro_torch.models.lm import serving_attention_shapes

    H, KV, D = serving_attention_shapes(get_config(ARCH))["prefill_attention_paged"]
    B, S = SERVE["max_slots"], SERVE["max_len"]
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        for T in FLEET_T:
            base, clens = [0] * B, fleet_chunk_lens(T, B)
            err, ok = check_prefill(prefill_case(gen, T, H, KV, D, S // PAGE, base, clens,
                                                 dtype))
            out.append({"kernel": "prefill_attention_paged", "shape": f"{ARCH} fleet prefill",
                        "B": B, "T": T, "H": H, "KV": KV, "head_dim": D, "S": S,
                        "page": PAGE, "base": base, "chunk_lens": clens,
                        "dtype": str(dtype), "max_abs_err": err, "tol": TOL_NOTE[dtype],
                        "ok": ok})
            if not ok:
                raise AssertionError(f"paged prefill kernel disagrees at the fleet's "
                                     f"shapes: {out[-1]}")
    return out


def head_dim_24_cases(gen):
    """The contiguous decode at head dim 24, which it alone takes
    (minicpm3's MLA decode at smoke width; the tensor-core body stages and
    multiplies it padded to 32), fp32 and bf16: at the shapes that path
    gives it (serving_shape_cases), and over the contiguous decode sweep's
    S, G, lengths and windows.  Drawn after every other case of the
    phase, whose inputs stay those of the parent commit."""
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        out += serving_shape_cases(gen, MLA, dtype, smoke=True)
        worst, n = 0.0, 0
        for S, G in itertools.product((32, MAX_LEN, 4096), (1, 4, 8, 16, 32)):
            lens = [0, 1, 7, 8, 15, 16, 17, 63, 64, 65, S - 1, S, S + 5]
            q, k, v, cl = contig_decode_case(gen, 2 * G, 2, 24, S, lens, dtype)
            for c, window in ((cl, 0), (cl, 8), (cl, 64), (cl, 100), (i32(S // 2 + 3), 0)):
                err, ok = check_contig_decode((q, k, v, c), window)
                n, worst = n + 1, max(worst, err)
                if not ok:
                    raise AssertionError(f"contiguous decode kernel disagrees at S {S} D 24 "
                                         f"G {G} window {window} {dtype}: {err}, empty rows "
                                         f"zero: {ok}")
        out.append({"kernel": "decode_attention", "sweep": "S x G x lengths x window at D 24",
                    "cases": n, "dtype": str(dtype), "max_abs_err": worst,
                    "tol": TOL_NOTE[dtype], "empty_rows_zero": True})
    return out


def serving_shape_cases(gen, arch, dtype, smoke: bool = False):
    """The attention kernels ``arch``'s serving path reaches, at the shapes
    it gives them (``serving_attention_shapes``: H and KV after padded_gqa
    and the head dim per kernel, from get_config(arch); B, S, T and the
    page from the serve engine's settings, SERVE): a GQA stack's both
    decodes and both prefills, an MLA stack's contiguous decode alone
    (its latents expanded per head: KV = H, D = nope + rope).  The decodes
    over batches of B rows whose lengths hold an empty row, the 16-key
    (tensor-core) and 32-position (CUDA-core) tile edges, the page edges,
    the 64-key edge and a full row; the prefills with full, partial,
    one-token and empty chunks, at base 0, inside a page, on the 64-key
    edge and across page edges, one ending on the row's last position
    (the contiguous one also a partial chunk running past S: its tail
    drops).  Caches bitwise, padding and empty rows exactly zero."""
    from repro_torch.models.lm import serving_attention_shapes

    shapes = serving_attention_shapes(get_config(arch, smoke=smoke))
    B, S, T, page = (SERVE[k] for k in ("max_slots", "max_len", "prefill_chunk_tokens",
                                        "page_size"))
    mp = S // page
    edges = [0, 1, 15, 16, 17, 31, 32, 33, 63, 64, 65, 100, 255, S - 17, S - 1, S]
    edges += [S] * (-len(edges) % B)
    checks = []
    for i in range(0, len(edges), B):
        lens = edges[i:i + B]
        if "decode_attention" in shapes:
            checks.append(("decode_attention", lens, *check_contig_decode(
                contig_decode_case(gen, *shapes["decode_attention"], S, lens, dtype))))
        if "decode_attention_paged" in shapes:
            checks.append(("decode_attention_paged", lens, *check_decode(
                decode_case(gen, *shapes["decode_attention_paged"], mp, lens, dtype))))
    base = ([0, 5, 64, 200, S - T, 13, 100, 3] * B)[:B]
    clens = ([T, 3, T, 0, T, 1, T // 2 + 8, T] * B)[:B]
    if "prefill_attention_paged" in shapes:
        checks.append(("prefill_attention_paged", list(zip(base, clens)), *check_prefill(
            prefill_case(gen, T, *shapes["prefill_attention_paged"], mp, base, clens,
                         dtype))))
    base[-2] = S - T // 2  # its last 8 tokens fall past S and drop
    if "prefill_attention" in shapes:
        checks.append(("prefill_attention", list(zip(base, clens)), *check_contig_prefill(
            contig_prefill_case(gen, T, *shapes["prefill_attention"], S, base, clens,
                                dtype))))
    name = f"{arch}{' smoke' if smoke else ''} serving"
    out = [{"kernel": kernel, "shape": name, "B": B, "H": shapes[kernel][0],
            "KV": shapes[kernel][1], "head_dim": shapes[kernel][2], "S": S, "T": T,
            "page": page, "rows": rows, "dtype": str(dtype), "max_abs_err": err,
            "tol": TOL_NOTE[dtype], "ok": ok}
           for kernel, rows, err, ok in checks]
    if {c["kernel"] for c in out} != set(shapes):
        raise AssertionError(f"{arch}: kernels checked {[c['kernel'] for c in out]}, "
                             f"path reaches {sorted(shapes)}")
    for c in out:
        if not c["ok"]:
            raise AssertionError(f"{c['kernel']} disagrees at {name} shapes: {c}")
    return out


def head_dim_96_cases(gen, dtype):
    """phi3-mini's head dim in all five attention kernels at a small KV 2,
    G 1 and 8 (its serving shapes are serving_shape_cases'): flash causal
    and full, both decodes (the contiguous one also a row past S) and both
    prefills with full, partial and empty chunks and one running past the
    cache.  Caches bitwise, padding and empty rows exactly zero."""
    out = []
    D, KV, mp, S = 96, 2, 16, 256
    for G in (1, 8):
        H = KV * G
        checks = [("flash_attention", *check_flash(flash_case(gen, 2, H, KV, 130, D, dtype),
                                                   causal)) for causal in (True, False)]
        lens = [0, 1, 15, 16, 17, 100, 255, 256]
        checks.append(("decode_attention_paged",
                       *check_decode(decode_case(gen, H, KV, D, mp, lens, dtype))))
        checks.append(("decode_attention", *check_contig_decode(
            contig_decode_case(gen, H, KV, D, S, lens + [300], dtype))))
        base, clens = [0, 5, 30, 200, 250], [17, 3, 17, 0, 6]
        checks.append(("prefill_attention_paged", *check_prefill(
            prefill_case(gen, 17, H, KV, D, mp, base, clens, dtype))))
        checks.append(("prefill_attention", *check_contig_prefill(contig_prefill_case(
            gen, 17, H, KV, D, S, [0, 5, 30, 250, 300], [17, 3, 17, 17, 4], dtype))))
        for kernel, err, ok in checks:
            out.append({"kernel": kernel, "head_dim": D, "G": G, "dtype": str(dtype),
                        "max_abs_err": err, "tol": TOL_NOTE[dtype], "ok": ok})
            if not ok:
                raise AssertionError(f"{kernel} disagrees at head dim 96: {out[-1]}")
    return out


def redesigned_sweeps(gen, dtype):
    """The five kernels redesigned for the tensor cores, on their edges:
    flash attention at every S around the 128-row block and 64-key tile,
    the training S and a long ragged one, D 16 to 128, G 1 and 8, causal
    and full, on [B, S, H, D] views; both prefills at chunks of 1 to 64
    tokens, bases 0 to 500 (a chunk running past max_pages or past the
    row), sentinels in every table, caches bitwise, padding rows zero; the
    contiguous decode at lengths across the 16-key tile and the row's end,
    windows and a scalar length, G 1 to 32, D 16 to 128, S 32 (one block
    a row on both bodies), 512 (one block a row on the tensor cores) and
    4096 (the combine pass), and bf16 off the 16-byte boundary (the
    CUDA-core body) at S 32 and 512, empty rows zero; the paged decode
    at pages of 8, 16, 64 and 128 (a 16-key tile spans pages, or a page
    tiles), rows of one page, 512 positions (one block a row on the
    tensor cores) and 4096 (the combine pass), lengths across the tile
    and page edges, S - 1, S and past S, windows 0, 1, 100 and past every
    length, a scalar length, G 1 to 32, D 16 to 128, sentinels in every
    table, and bf16 off the 16-byte boundary (the CUDA-core body, split
    and one block a row), empty rows zero.  One summary per kernel; any
    case past the tolerance fails the phase."""
    worst, n = 0.0, 0
    for S, D, G, causal in itertools.product((1, 63, 64, 65, 127, 512, 1000),
                                             build.HEAD_DIMS, (1, 8), (True, False)):
        err, ok = check_flash(flash_case(gen, 2, 2 * G, 2, S, D, dtype), causal)
        n, worst = n + 1, max(worst, err)
        if not ok:
            raise AssertionError(f"flash kernel disagrees at S {S} D {D} G {G} "
                                 f"causal {causal} {dtype}: {err}")
    out = [{"kernel": "flash_attention", "sweep": "S x D x G x causal", "cases": n,
            "dtype": str(dtype), "max_abs_err": worst, "tol": TOL_NOTE[dtype]}]
    worst, n = 0.0, 0
    base = [0, 5, 16, 447, 500, 3]
    for T in (1, 15, 16, 17, 64):
        clens = [T, max(T - 3, 0), T, T, T, 0]
        err, ok = check_prefill(sweep_prefill_case(gen, T, base, clens, dtype))
        n, worst = n + 1, max(worst, err)
        if not ok:
            raise AssertionError(f"paged prefill kernel disagrees at T {T} {dtype}: "
                                 f"{err}, pools equal and padding zero: {ok}")
    out.append({"kernel": "prefill_attention_paged", "sweep": "T x base", "cases": n,
                "dtype": str(dtype), "max_abs_err": worst, "tol": TOL_NOTE[dtype],
                "pools_equal_pad_zero": True})
    worst, n = 0.0, 0
    for T in (1, 15, 16, 17, 64):
        clens = [T, max(T - 3, 0), T, T, T, 0]
        err, ok = check_contig_prefill(contig_prefill_case(gen, T, 32, 4, 64, MAX_LEN, base,
                                                           clens, dtype))
        n, worst = n + 1, max(worst, err)
        if not ok:
            raise AssertionError(f"contiguous prefill kernel disagrees at T {T} {dtype}: "
                                 f"{err}, caches equal and padding zero: {ok}")
    out.append({"kernel": "prefill_attention", "sweep": "T x base", "cases": n,
                "dtype": str(dtype), "max_abs_err": worst, "tol": TOL_NOTE[dtype],
                "caches_equal_pad_zero": True})
    worst, n = 0.0, 0
    for S, D, G in itertools.product((32, MAX_LEN, 4096), build.HEAD_DIMS, (1, 4, 8, 16, 32)):
        lens = [0, 1, 7, 8, 15, 16, 17, 63, 64, 65, S - 1, S, S + 5]
        q, k, v, cl = contig_decode_case(gen, 2 * G, 2, D, S, lens, dtype)
        for c, window in ((cl, 0), (cl, 8), (cl, 64), (cl, 100), (i32(S // 2 + 3), 0)):
            err, ok = check_contig_decode((q, k, v, c), window)
            n, worst = n + 1, max(worst, err)
            if not ok:
                raise AssertionError(f"contiguous decode kernel disagrees at S {S} D {D} "
                                     f"G {G} window {window} {dtype}: {err}, empty rows "
                                     f"zero: {ok}")
    if dtype == torch.bfloat16:  # off the 16-byte boundary: the CUDA-core body
        for S in (32, MAX_LEN):
            args = tuple(unaligned(t) for t in contig_decode_case(
                gen, 32, 4, 64, S, [0, 1, 17, S - 1, S, S + 5], dtype)[:3])
            for window in (0, 8):
                err, ok = check_contig_decode(args + (i32([0, 1, 17, S - 1, S, S + 5]),),
                                              window)
                n, worst = n + 1, max(worst, err)
                if not ok:
                    raise AssertionError(f"contiguous decode kernel disagrees on unaligned "
                                         f"bf16 at S {S} window {window}: {err}, empty "
                                         f"rows zero: {ok}")
    out.append({"kernel": "decode_attention",
                "sweep": "S x D x G x lengths x window (+ unaligned bf16)",
                "cases": n, "dtype": str(dtype), "max_abs_err": worst, "tol": TOL_NOTE[dtype],
                "empty_rows_zero": True})
    worst, n = 0.0, 0
    for page, S, D, G in itertools.product((8, 16, 64, 128), (None, MAX_LEN, 4096),
                                           build.HEAD_DIMS, (1, 4, 8, 16, 32)):
        S = S or page  # None: one page a row
        lens = paged_decode_lens(S, page)
        q, kp, vp, bt, cl = decode_case(gen, 2 * G, 2, D, S // page, lens, dtype, page)
        for c, window in ((cl, 0), (cl, 1), (cl, 100), (cl, S + 5), (i32(S // 2 + 3), 0)):
            err, ok = check_decode((q, kp, vp, bt, c), window)
            n, worst = n + 1, max(worst, err)
            if not ok:
                raise AssertionError(f"paged decode kernel disagrees at page {page} S {S} "
                                     f"D {D} G {G} window {window} {dtype}: {err}, empty "
                                     f"rows zero: {ok}")
    if dtype == torch.bfloat16:  # off the 16-byte boundary: the CUDA-core body
        for page, max_pages in ((PAGE, MAX_LEN // PAGE), (64, 1)):
            S = page * max_pages
            lens = [0, 1, 17, S - 1, S, S + 5]
            q, kp, vp, bt, cl = decode_case(gen, 32, 4, 64, max_pages, lens, dtype, page)
            args = tuple(unaligned(t) for t in (q, kp, vp)) + (bt, cl)
            for window in (0, 8):
                err, ok = check_decode(args, window)
                n, worst = n + 1, max(worst, err)
                if not ok:
                    raise AssertionError(f"paged decode kernel disagrees on unaligned bf16 "
                                         f"at page {page} window {window}: {err}, empty "
                                         f"rows zero: {ok}")
    out.append({"kernel": "decode_attention_paged",
                "sweep": "page x S x D x G x lengths x window (+ unaligned bf16)",
                "cases": n, "dtype": str(dtype), "max_abs_err": worst, "tol": TOL_NOTE[dtype],
                "empty_rows_zero": True})
    return out


def paged_decode_lens(S, page):
    """An empty row, one token, the 16-key tile edges, the page edges, S - 1,
    S and a length past S."""
    return [0, 1, 15, 16, 17, page - 1, page, page + 1, 2 * page + 1, S - 1, S, S + 5]


def unaligned(x):
    """A contiguous copy of ``x`` whose data starts 2 bytes past a 16-byte
    boundary (so either decode takes its CUDA-core body)."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    return buf[1:].view(x.shape).copy_(x)


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
    """Both prefill wrappers (scatter + attention), both decodes and the
    decode append on the kernel, once each at the serving shape under
    sync-debug "error": a host sync raises and fails the phase."""
    q, kn, vn, kp, vp, bt, bs, cl = sweep_prefill_case(
        gen, 64, [64, 0, 0, 0], [64, 0, 5, 0], torch.bfloat16, max_pages=8)
    idx = i32([5, 17, -1, 127])
    kr, vr = randn(gen, (4, 4, 64), torch.bfloat16), randn(gen, (4, 4, 64), torch.bfloat16)
    contig = contig_prefill_case(gen, 64, 32, 4, 64, MAX_LEN, [64, 0, 0, 0], [64, 0, 5, 0],
                                 torch.bfloat16)
    qd, kc, vc, lens = contig_decode_case(gen, 32, 4, 64, MAX_LEN, [128, 1, 5, 0],
                                          torch.bfloat16)
    dec_args = decode_case(gen, 32, 4, 64, 8, [128, 1, 5, 0], torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pf.prefill_attention_paged_kernel(q, kn, vn, kp, vp, bt, bs, cl)
        ops.paged_append(kp, vp, bt, idx, kr, vr)
        dec.decode_attention_paged_kernel(*dec_args)
        pf.prefill_attention_kernel(*contig)
        dec.decode_attention_kernel(qd, kc, vc, lens)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return {"kernel": "serving kernels", "check": "no host sync",
            "calls": ["prefill_attention_paged_kernel", "ops.paged_append",
                      "decode_attention_paged_kernel", "prefill_attention_kernel",
                      "decode_attention_kernel"],
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
    return ServeEngine(cfg, params=params, **SERVE, **kw)


def zero_counts() -> None:
    for fn in COUNTED.values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in COUNTED.items()}


def path_kernels(cfg, layout):
    """The kernels the serving path of ``cfg`` launches on ``layout``: a
    GQA stack the layout's decode and prefill (and, paged, the scatter);
    an MLA stack the contiguous decode alone on either layout (its latent
    writes and gathers are plain PyTorch, as JAX's are plain jnp)."""
    if cfg.attention == "mla":
        return ("decode_attention",)
    return PATH_KERNELS[layout]


def phase_serve(cfg, params, layout, n: int = 16, round_: int = 0, temperature=0.0):
    """The main path on one KV layout, ``n`` requests (sampled at
    ``temperature`` when > 0, each from its own seed): every counter
    zeroed just before the run and read just after."""
    work = mixed_requests(n, cfg.vocab_size, SEED)
    path = path_kernels(cfg, layout)
    sampling = dict(temperature=temperature) if temperature > 0 else {}
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
    reqs = [eng.submit(p, max_new_tokens=g, seed=SEED + i, **sampling)
            for i, (p, g) in enumerate(work)]
    eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    bad = [r.rid for r in reqs
           if r.state is not RequestState.DONE or len(r.tokens) != r.max_new_tokens
           or not all(0 <= t < cfg.padded_vocab for t in r.tokens)]
    if bad:
        raise AssertionError(f"requests not served in full: {bad}")
    dec_name, pf_name = (path + (None,))[:2]
    if min(launches[n] for n in path) <= 0:
        raise AssertionError(f"a kernel never launched on the {layout} path: "
                             f"{launches}")
    if "paged_scatter" in path and \
            launches["paged_scatter"] != launches[dec_name] + launches[pf_name]:
        raise AssertionError(f"the paged scatter launched {launches['paged_scatter']} "
                             f"times, not once per prefill call and decode append")
    others = {n: c for n, c in launches.items() if n not in path}
    if any(others.values()):
        raise AssertionError(f"the {layout} path launched another layout's "
                             f"kernels: {others}")
    stats = eng.stats()
    if stats["kv_layout"] != layout:
        raise AssertionError(f"engine reports layout {stats['kv_layout']}")
    ttft = np.array([r.ttft_s for r in reqs]) * 1e3
    gaps = np.array([g for r in reqs for g in r.inter_token_s]) * 1e3
    tokens = sum(len(r.tokens) for r in reqs)
    out = {"phase": "serve", "ok": True, "kv_layout": layout, "round": round_,
           "arch": cfg.name, "temperature": temperature, "path_kernels": list(path),
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
           "launches_per_prefill_chunk": (launches[pf_name] / stats["prefill_chunks"]
                                          if pf_name else None),
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
               lib_ms, lib_note, at, source=None, flops_per_s=BF16_FLOPS_PER_S,
               lib_us=None):
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source or name}.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms, "library_note": lib_note,
            "library_device_us": lib_us,
            "bytes": bytes_, "flops": flops, "at": at}


def device_window(fn, reps: int, tries: int = 3):
    """``{kernel name: [device ms, launches]}`` of ``reps`` runs of ``fn``
    under torch.profiler (the device's own time, free of host dispatch).
    A window that comes back without a single device event (CUPTI drops
    whole windows now and then; PERF.md section 7) is opened again, up to
    ``tries`` times, each empty one noted on stderr."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by_name = device_kernels(prof)[1]
        if by_name:
            return by_name
        print(f"chip_smoke: profiler window {attempt + 1} of {tries} had no device "
              f"events", file=sys.stderr, flush=True)
    return {}


def device_us_per_call(fn, reps: int = 10):
    """Device us per call of ``fn``: every device kernel its call launches,
    in all and by kernel name; (None, {}) (not measured) when the window
    came back without device events."""
    by_name = device_window(fn, reps)
    if not by_name:
        return None, {}
    by_kernel = {}
    for name, (ms, _) in by_name.items():
        short = name.replace("void ", "").replace("(anonymous namespace)::", "")
        short = short.split("(")[0][:80]
        by_kernel[short] = by_kernel.get(short, 0.0) + 1e3 * ms / reps
    return sum(by_kernel.values()), by_kernel


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
    split = profiled_us(lambda: dec.decode_attention_paged_kernel(*nxt()),
                        SYMBOLS["decode_attention_paged"])
    lib = rotate([sdpa_inputs(q[:, :, None], kp, vp, bt,
                              (torch.arange(mb * PAGE, device="cuda")[None, :]
                               < cl[:, None])[:, None, None, :], H, KV)
                  for q, kp, vp, bt, cl in cases])
    lib_ms = cuda_ms(lambda: sdpa(*lib()))
    lib_us = device_us_per_call(lambda: sdpa(*lib()))[0]
    live = sum(lens)
    bytes_ = (2 * live * KV * D * esz          # live K and V, read once
              + 2 * B * H * D * esz            # q read, out written
              + 4 * B * (mb + 1))              # table and lengths
    rows.append(kernel_row(
        "decode_attention_paged", "src/repro/kernels/decode_attention.py:199",
        launches, err, ms, plain_ms, bytes_, 4 * H * D * live, lib_ms, PAGED_SDPA,
        {"B": B, "H": H, "KV": KV, "D": D, "page": PAGE, "max_pages": mb,
         "cache_len": lens, "window": 0, "dtype": str(dt)}, lib_us=lib_us))
    redesigned(rows[-1], sum(split.values()), split, design="mma.sync m16n8k16, GQA-packed",
               header="decode_tc.cuh")
    # the same call in fp32: the CUDA-core body with its ~264-block split-K spans
    rows[-1]["fp32"] = fp32_timing(
        cases, dec.decode_attention_paged_kernel, dec.decode_attention_paged_plain,
        check_decode, bytes_, esz, live, KV, B, H, D, L,
        "decode_split_kernel + decode_combine_kernel (CUDA cores)")

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
    lib_us = device_us_per_call(lambda: sdpa(*lib()))[0]
    rows.append(kernel_row(
        "prefill_attention_paged", "src/repro/kernels/prefill_attention.py:222",
        launches, err, ms, plain_ms,
        prefill_bytes(base, clens, T, B, H, KV, D, esz, 4 * B * (mbp + 2)),
        prefill_flops(base, clens, H, D), lib_ms, PAGED_SDPA,
        {"B": B, "T": T, "H": H, "KV": KV, "D": D, "page": PAGE, "max_pages": mbp,
         "base": base, "chunk_lens": clens, "dtype": str(dt),
         "scatter_ms": scatter_ms, "scatter": "paged_scatter_kernel"}, lib_us=lib_us))
    redesigned(rows[-1], sum(split.values()), split)

    # the contiguous slot cache: each slot owns a [MAX_LEN, KV, D] row
    S = MAX_LEN
    lens = [min(n, S) for n in shapes["lens"]]
    cases = [contig_decode_case(gen, H, KV, D, S, lens, dt) for _ in range(L)]
    err = max(check_contig_decode(a)[0] for a in cases[:2])
    nxt = rotate(cases)
    ms = cuda_ms(lambda: dec.decode_attention_kernel(*nxt()))
    plain_ms = cuda_ms(lambda: dec.decode_attention_plain(*nxt()))
    split = profiled_us(lambda: dec.decode_attention_kernel(*nxt()),
                        SYMBOLS["decode_attention"])
    lib = rotate([contig_sdpa_inputs(
        q[:, :, None], k, v,
        (torch.arange(S, device="cuda")[None, :] < cl[:, None])[:, None, None, :],
        H, KV) for q, k, v, cl in cases])
    lib_ms = cuda_ms(lambda: sdpa(*lib()))
    lib_us = device_us_per_call(lambda: sdpa(*lib()))[0]
    live = sum(lens)
    bytes_ = (2 * live * KV * D * esz          # live K and V, read once
              + 2 * B * H * D * esz            # q read, out written
              + 4 * B)                         # lengths
    rows.append(kernel_row(
        "decode_attention", "src/repro/kernels/decode_attention.py:114",
        launches, err, ms, plain_ms, bytes_, 4 * H * D * live, lib_ms, CONTIG_SDPA,
        {"B": B, "H": H, "KV": KV, "D": D, "S": S, "cache_len": lens,
         "window": 0, "dtype": str(dt)}, lib_us=lib_us))
    redesigned(rows[-1], sum(split.values()), split, design="mma.sync m16n8k16, GQA-packed",
               header="decode_tc.cuh")
    # the same call in fp32: the CUDA-core body with its ~264-block split-K spans
    rows[-1]["fp32"] = fp32_timing(
        cases, dec.decode_attention_kernel, dec.decode_attention_plain, check_contig_decode,
        bytes_, esz, live, KV, B, H, D, L,
        "contig_decode_split_kernel + decode_combine_kernel (CUDA cores)")

    cases = [contig_prefill_case(gen, T, H, KV, D, S, base, clens, dt)
             for _ in range(L)]
    err = max(check_contig_prefill(a)[0] for a in cases[:2])
    nxt = rotate(cases)
    ms = cuda_ms(lambda: pf.prefill_attention_kernel(*nxt()))
    plain_ms = cuda_ms(lambda: pf.prefill_attention_plain(*nxt()))
    split = profiled_us(lambda: pf.prefill_attention_kernel(*nxt()),
                        SYMBOLS["prefill_attention"])
    lib = rotate([contig_sdpa_inputs(q.transpose(1, 2).contiguous(), kc, vc,
                                     causal_mask(bs, T, S), H, KV)
                  for q, kn, vn, kc, vc, bs, cl in cases])
    lib_ms = cuda_ms(lambda: sdpa(*lib()))
    lib_us = device_us_per_call(lambda: sdpa(*lib()))[0]
    rows.append(kernel_row(
        "prefill_attention", "src/repro/kernels/prefill_attention.py:162",
        launches, err, ms, plain_ms,
        prefill_bytes(base, clens, T, B, H, KV, D, esz, 4 * B * 2),
        prefill_flops(base, clens, H, D), lib_ms, CONTIG_SDPA,
        {"B": B, "T": T, "H": H, "KV": KV, "D": D, "S": S, "base": base,
         "chunk_lens": clens, "dtype": str(dt)}, lib_us=lib_us))
    redesigned(rows[-1], sum(split.values()), split)
    emit({"phase": "timing", "ok": True, "rows": rows})
    return rows


def fp32_timing(cases, kernel, plain, check, bytes_, esz, live, KV, B, H, D, L, body):
    """A decode's timing-shape call in fp32 (its CUDA-core body): the bf16
    ``cases`` cast, held to the plain version, timed by CUDA events and by
    device time per call, with its bound (``bytes_`` of the bf16 call at
    4 bytes an element)."""
    cases = [tuple(t.float() if t.is_floating_point() else t for t in a) for a in cases]
    err = max(check(a)[0] for a in cases[:2])
    if err > TOL[torch.float32]:
        raise AssertionError(f"fp32 {kernel.__name__} disagrees at the timing shape: {err}")
    nxt = rotate(cases)
    us, by_kernel = device_us_per_call(lambda: kernel(*nxt()), reps=2 * L)
    t_bytes = (bytes_ + 2 * (live * KV + B * H) * D * (4 - esz)) / HBM_BYTES_PER_S * 1e3
    return {"body": body, "max_abs_err": err, "tol": TOL[torch.float32],
            "ms": cuda_ms(lambda: kernel(*nxt())), "plain_ms": cuda_ms(lambda: plain(*nxt())),
            "device_us_per_launch": us, "device_us_by_kernel": by_kernel,
            "bound_ms": max(t_bytes, 4 * H * D * live / FP32_FLOPS_PER_S * 1e3)}


def redesigned(row, device_us, split=None, design="wgmma", header="attn_tc.cuh"):
    """The fields of a kernel redesigned for the tensor cores: its design,
    its device time per call at the row's shape and the share of the
    bound that time and the wrapper's time reach."""
    row.update({"design": design, "header": f"src/repro_torch/kernels/csrc/{header}",
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


def phase_profile(cfg, params, layout, n: int = 8, temperature: float = 0.0,
                  window=None):
    """Where a serving run's time goes on one layout: torch.profiler over
    the first ``n`` requests of the workload, sampled at ``temperature``
    when > 0 (a separate, unmeasured run; the profiler's own host cost
    inflates the wall time and the idle share).  With ``window``, only
    that many engine steps are profiled, once every prompt is in and all
    ``n`` requests decode (the profiler over a 62-layer model's whole run
    takes minutes).  Returns the device time per launch of the path's
    kernels that ran."""
    from torch.profiler import ProfilerActivity, profile

    work = mixed_requests(16, cfg.vocab_size, SEED)[:n]
    path = path_kernels(cfg, layout)
    sampling = dict(temperature=temperature) if temperature > 0 else {}
    eng = serve_engine(cfg, params, kv_layout=layout)
    before = 0
    if window:
        for i, (p, g) in enumerate(work):
            eng.submit(p, max_new_tokens=g, seed=SEED + i, **sampling)
        while eng.queue or (eng.prefill_pos >= 0).any():
            eng.step()
        stats = eng.stats()
        before = stats.get("decode_steps", 0) + stats.get("prefill_chunks", 0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if window:
            for _ in range(window):
                eng.step()
        else:
            for i, (p, g) in enumerate(work):
                eng.submit(p, max_new_tokens=g, seed=SEED + i, **sampling)
            eng.run_until_drained()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels, by_name = device_kernels(prof)
    busy_ms = sum(v[0] for v in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    # the port's own kernels: device time per launch, free of the host
    # cost that the CUDA-event timing of back-to-back wrapper calls carries
    # a decode window runs no prefill chunk
    ran = [k for k in path if not (window and k.startswith("prefill"))]
    ours = {}
    for kernel in ran:
        for name in SYMBOLS[kernel]:
            hits = [v for k, v in by_name.items() if f"::{name}<" in k]
            ms, launches = sum(v[0] for v in hits), sum(v[1] for v in hits)
            if not launches:
                raise AssertionError(f"the profiler saw no {name} launch")
            ours[name] = {"ms": ms, "launches": launches,
                          "us_per_launch": 1e3 * ms / launches}
    combine = sum(v[1] for k, v in by_name.items() if "decode_combine_kernel" in k)
    if combine:
        raise AssertionError(f"the {layout} decode ran {combine} combine passes at "
                             f"S {MAX_LEN}: it must be one launch")
    stats = eng.stats()
    steps = stats["decode_steps"] + stats["prefill_chunks"] - before
    if window:
        eng.run_until_drained()
    cpu_ops = sum(1 for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CPU
                  and e.name.startswith("aten::") and e.cpu_parent is None)
    emit({"phase": "profile", "ok": True, "arch": cfg.name, "kv_layout": layout,
          "requests": n, "temperature": temperature, "window_steps": window,
          "wall_ms": wall_ms,
          "device_busy_ms": busy_ms,
          "device_idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
          "gpu_kernels": len(kernels), "engine_steps": steps,
          "gpu_kernels_per_step": len(kernels) / steps,
          "top_level_aten_ops_per_step": cpu_ops / steps,
          "port_kernels": ours, "combine_launches": combine,
          "top_kernels": [{"name": k[:80], "ms": v[0], "launches": v[1]}
                          for k, v in top]})
    return {kernel: sum(ours[name]["us_per_launch"] for name in SYMBOLS[kernel])
            for kernel in ran}


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


def serve_rounds(cfg, params, rounds: int):
    """The serve phase: ``rounds`` rounds of phase_serve on both layouts in
    turn, on the same engine settings and requests, then one line with
    each layout's tokens/s, TTFT p50 and step p50 per round and their
    median, min and max.  Returns the paged layout's kernel launches (first
    round), the contiguous layout's, and the first paged run's shapes."""
    keys = ("tokens_per_s", "ttft_ms_p50", "step_ms_p50")
    runs = {layout: {key: [] for key in keys} for layout in LAYOUTS}
    launches, shapes = {}, None
    for r in range(rounds):
        for layout in LAYOUTS:
            out, layout_shapes = phase_serve(cfg, params, layout, round_=r)
            for key in keys:
                runs[layout][key].append(out[key])
            if r == 0:
                launches.update({n: out["launches"][n] for n in PATH_KERNELS[layout]})
                shapes = shapes or layout_shapes  # the paged run's buckets
    spread = {layout: {key: {"runs": v, "median": float(np.median(v)), "min": min(v),
                             "max": max(v)} for key, v in by_key.items()}
              for layout, by_key in runs.items()}
    spread["paged_over_contiguous_tokens_per_s_median"] = (
        spread["paged"]["tokens_per_s"]["median"]
        / spread["contiguous"]["tokens_per_s"]["median"])
    emit({"phase": "serve_spread", "ok": True, "arch": cfg.name, "rounds": rounds,
          "requests": 16, "src": str(ARGS.src.resolve()), **spread})
    return launches, shapes


def compare_kernels(cfg, shapes):
    """The serving kernels' wrappers at the timing rows' shapes, with only
    the public wrappers, so another checkout's package runs it too: CUDA
    events per call and the device us per call by kernel name (every
    device kernel the call launches, under torch.profiler).  The bf16
    serving calls, and both decodes in fp32 (their CUDA-core bodies)."""
    H, KV, D, L, B = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.num_layers, 8
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    S, mb = MAX_LEN, shapes["decode_mb"]
    T, mbp = shapes["prefill_T_mb"]
    base, clens = [64] + [0] * (B - 1), [T] + [0] * (B - 1)
    calls = {}
    for dt in (torch.bfloat16, torch.float32):
        lens = [min(n, S) for n in shapes["lens"]]
        calls[f"decode_attention {dt}"] = (dec.decode_attention_kernel, [
            contig_decode_case(gen, H, KV, D, S, lens, dt) for _ in range(L)])
    dt = torch.bfloat16
    calls["prefill_attention"] = (pf.prefill_attention_kernel, [
        contig_prefill_case(gen, T, H, KV, D, S, base, clens, dt) for _ in range(L)])
    lens = [min(n, mb * PAGE) for n in shapes["lens"]]
    for dt in (torch.bfloat16, torch.float32):
        calls[f"decode_attention_paged {dt}"] = (dec.decode_attention_paged_kernel, [
            decode_case(gen, H, KV, D, mb, lens, dt) for _ in range(L)])
    dt = torch.bfloat16
    calls["prefill_attention_paged"] = (pf.prefill_attention_paged_kernel, [
        prefill_case(gen, T, H, KV, D, mbp, base, clens, dt) for _ in range(L)])
    out = {}
    for name, (fn, cases) in calls.items():
        nxt = rotate(cases)
        total, by_kernel = device_us_per_call(lambda: fn(*nxt()), reps=2 * L)
        out[name] = {"ms": cuda_ms(lambda: fn(*nxt())), "device_us": total,
                     "device_us_by_kernel": by_kernel}
    return out


def phase_compare(rounds: int):
    """One tree's serve spread and serving kernel times (see the module
    docstring's second form)."""
    t0 = time.perf_counter()
    build.build_all()
    build_s = time.perf_counter() - t0
    cfg = get_config(ARCH)
    params = init_params(torch.Generator(device="cuda").manual_seed(SEED),
                         model_specs(cfg), "cuda")
    _, shapes = serve_rounds(cfg, params, rounds)
    emit({"phase": "compare", "ok": True, "src": str(ARGS.src.resolve()),
          "build_s": build_s, "gpu": gpu_line(),
          "shape": {"B": 8, "H": cfg.num_heads, "KV": cfg.num_kv_heads, "D": cfg.head_dim,
                    "S": MAX_LEN, "cache_len": shapes["lens"],
                    "decode_max_pages": shapes["decode_mb"],
                    "prefill_T_max_pages": shapes["prefill_T_mb"]},
          "kernels": compare_kernels(cfg, shapes)})


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
    emit({"phase": "stream", "ok": True, "arch": cfg.name, "requests": n,
          "path_kernels": {layout: list(path_kernels(cfg, layout)) for layout in LAYOUTS},
          "tokens": sum(len(s) for s in streams["paged", "auto"]),
          "compute_dtype": str(cfg32.compute_dtype),
          "identical": ["paged kernel == paged plain",
                        "contiguous kernel == contiguous plain",
                        "contiguous kernel == paged kernel"]})


def phase_phi3():
    """phi3-mini-3.8b at its published widths (head dim 96, G 1): both
    decodes and both prefills held against their plain versions at the
    shapes its serving path gives them, fp32 and bf16 (one line); then it
    serves PHI3_REQUESTS greedy requests on each KV layout, through the
    layout's kernels alone (phase_serve's checks; one serve line per
    layout)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    cases = [c for dtype in (torch.float32, torch.bfloat16)
             for c in serving_shape_cases(gen, PHI3, dtype)]
    emit({"phase": "phi3_kernels", "ok": True, "arch": PHI3, "cases": cases})
    cfg = get_config(PHI3)
    params = init_params(torch.Generator(device="cuda").manual_seed(SEED),
                         model_specs(cfg), "cuda")
    for layout in LAYOUTS:
        phase_serve(cfg, params, layout, n=PHI3_REQUESTS)
    del params
    torch.cuda.empty_cache()


# -- seeded sampling ------------------------------------------------------------


def threefry_np(k1, k2, x1, x2):
    """threefry2x32 in numpy uint32 (wrapping) arithmetic, written from the
    cipher's definition (Salmon et al. 2011, 20 rounds): the reference the
    port's int64 torch version is held to on the card."""
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))
    ks = (k1, k2, k1 ^ k2 ^ np.uint32(0x1BD11BDA))
    x1, x2 = x1 + ks[0], x2 + ks[1]
    for i in range(5):
        for r in rot[i % 2]:
            x1 = x1 + x2
            x2 = ((x2 << np.uint32(r)) | (x2 >> np.uint32(32 - r))) ^ x1
        x1 = x1 + ks[(i + 1) % 3]
        x2 = x2 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x1, x2


def threefry_reference(seeds, n):
    """numpy split keys [len(seeds), 2, 2], random bits [len(seeds), n] and
    the uniforms in [tiny, 1) of the bits, as jax.random computes them with
    partitionable threefry: counter i is (i >> 32, i & 0xffffffff)."""
    keys = np.stack([np.array([(s >> 32) & 0xFFFFFFFF, s & 0xFFFFFFFF], np.uint32)
                     for s in seeds])
    k1, k2 = keys[:, :1], keys[:, 1:]
    w1, w2 = threefry_np(k1, k2, np.zeros((1, 2), np.uint32),
                         np.arange(2, dtype=np.uint32)[None])
    split = np.stack([w1, w2], axis=-1)
    w1, w2 = threefry_np(k1, k2, np.zeros((1, n), np.uint32),
                         np.arange(n, dtype=np.uint32)[None])
    bits = w1 ^ w2
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1)
    tiny = np.finfo(np.float32).tiny
    uniform = np.maximum(np.float32(tiny),
                         floats * (np.float32(1) - np.float32(tiny)) + np.float32(tiny))
    return keys, split, bits, uniform


def phase_sampling(cfg, params):
    """Seeded sampling on the card (tinyllama-1.1b at full width): the
    threefry split keys, random bits and uniforms of SAMPLE_SEEDS seeds
    (half >= 2^32) over the vocabulary bitwise against numpy; on an fp32
    paged engine the same seed twice gives one stream and another seed
    another, top_k=1 is greedy, and a stream checkpointed, released and
    restored mid-decode goes on as the uninterrupted one; then the serve
    phase's 16 requests in bf16, greedy and sampled, with tokens/s each."""
    from repro_torch.serve import sampling

    rng = np.random.default_rng(SEED)
    half = SAMPLE_SEEDS // 2
    seeds = ([0, 1, 2**31, 2**32 - 1] + [int(x) for x in rng.integers(0, 2**32, half - 4)]
             + [2**32, 2**63 - 1] + [int(x) for x in rng.integers(2**32, 2**63 - 1, half - 2,
                                                                   dtype=np.int64)])
    V = cfg.padded_vocab
    keys, want_split, want_bits, want_u = threefry_reference(seeds, V)
    tkeys = torch.from_numpy(keys.astype(np.int64)).cuda()
    got_split = sampling.split(tkeys, 2).cpu().numpy().astype(np.uint32)
    got_bits = sampling.random_bits(tkeys, V).cpu().numpy().astype(np.uint32)
    tiny = float(np.finfo(np.float32).tiny)
    got_u = sampling.uniform(tkeys, V, tiny, 1.0).cpu().numpy()
    bitwise = {"split": bool(np.array_equal(got_split, want_split)),
               "bits": bool(np.array_equal(got_bits, want_bits)),
               "uniform": bool(np.array_equal(got_u.view(np.uint32), want_u.view(np.uint32)))}
    if not all(bitwise.values()):
        raise AssertionError(f"threefry on the card differs from numpy: {bitwise}")

    cfg32 = cfg.with_overrides(compute_dtype=torch.float32)
    prompt = mixed_requests(1, cfg.vocab_size, SEED + 4)[0][0]

    def engine():
        return serve_engine(cfg32, params, kv_layout="paged")

    eng = engine()
    a, b, c = (eng.submit(prompt, max_new_tokens=16, temperature=SAMPLE_TEMPERATURE, seed=s)
               for s in (123, 123, 2**32 + 123))
    greedy = eng.submit(prompt, max_new_tokens=16)
    top1 = eng.submit(prompt, max_new_tokens=16, temperature=3.0, top_k=1, seed=7)
    eng.run_until_drained()
    checks = {"same_seed_same_stream": a.tokens == b.tokens,
              "other_seed_other_stream": a.tokens != c.tokens,
              "top_k_1_is_greedy": top1.tokens == greedy.tokens}
    eng = engine()
    resumed = eng.submit(prompt, max_new_tokens=16, temperature=SAMPLE_TEMPERATURE, seed=123)
    for _ in range(6):
        eng.step()
    state = eng.checkpoint()
    eng._release_state()
    eng.restore(state)
    eng.run_until_drained()
    checks["restored_stream_resumes"] = resumed.tokens == a.tokens
    del eng, state
    if not all(checks.values()):
        raise AssertionError(f"seeded sampling on the card: {checks}")
    runs = {name: phase_serve(cfg, params, "paged", temperature=t)[0]
            for name, t in (("greedy", 0.0), ("sampled", SAMPLE_TEMPERATURE))}
    for t in (0.0, SAMPLE_TEMPERATURE):  # one decode window each, side by side
        phase_profile(cfg, params, "paged", temperature=t, window=PROFILE_WINDOW)
    emit({"phase": "sampling", "ok": True, "arch": cfg.name, "seeds": len(seeds),
          "seeds_at_or_above_2^32": sum(x >= 2**32 for x in seeds), "vocab": V,
          "bitwise": bitwise, "checks": checks, "compute_dtype_checks": "float32",
          "tokens_per_s": {k: r["tokens_per_s"] for k, r in runs.items()},
          "step_ms_p50": {k: r["step_ms_p50"] for k, r in runs.items()},
          "sampled_over_greedy_tokens_per_s":
              runs["sampled"]["tokens_per_s"] / runs["greedy"]["tokens_per_s"]})


# -- MLA and MoE serving at full width -----------------------------------------------


def serve_family(arch, param_dtype=torch.float32, stream=False):
    """``arch`` at its published widths (random weights from a seeded
    torch.Generator, stored in ``param_dtype``): its path's kernels held
    against their plain versions at the shapes its serving path gives
    them (fp32 and bf16); MLA_MOE_REQUESTS greedy requests per layout,
    the layout's path kernels launched and no other (phase_serve); with
    ``stream``, the fp32 streams of the kernel and plain paths token for
    token (phase_stream).  Returns each layout's launches and the paged
    run's shapes; the parameters are freed."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    cases = [c for dtype in (torch.float32, torch.bfloat16)
             for c in serving_shape_cases(gen, arch, dtype)]
    cfg = get_config(arch).with_overrides(param_dtype=param_dtype)
    specs = map_tree(lambda p: Param(p.shape, p.axes, param_dtype, p.init, p.scale),
                     model_specs(cfg))
    params = init_params(torch.Generator(device="cuda").manual_seed(SEED), specs, "cuda")
    n_params = sum(t.numel() for t in tree_leaves(params))
    launches, shapes = {}, {}
    for layout in LAYOUTS:
        out, layout_shapes = phase_serve(cfg, params, layout, n=MLA_MOE_REQUESTS)
        launches[layout] = out["launches"]
        shapes[layout] = layout_shapes
    phase_profile(cfg, params, "paged", n=MLA_MOE_REQUESTS, window=PROFILE_WINDOW)
    emit({"phase": f"{arch}_kernels", "ok": True, "arch": arch, "params": n_params,
          "param_dtype": str(param_dtype), "param_gb": n_params * (torch.finfo(
              param_dtype).bits // 8) / 1e9, "layers": cfg.num_layers,
          "path_kernels": {layout: list(path_kernels(cfg, layout)) for layout in LAYOUTS},
          "cases": cases})
    if stream:
        phase_stream(cfg, params, n=MLA_MOE_REQUESTS)
    del params
    torch.cuda.empty_cache()
    return cfg, launches, shapes

def fleet(cfg, params, prefix, **kw):
    """A started EngineRouter over two engines of the serve phase's
    settings on the card, sharing ``params``."""
    from repro_torch.serve import build_fleet

    return build_fleet(cfg, num_engines=2, params=params, name_prefix=prefix,
                       device="cuda", **SERVE, **kw).start()


def fleet_streams_equal(name, cfg32, params, work, reqs, want):
    """Every request DONE with its full budget, and its greedy stream the
    undisturbed engine's, token for token (else the first diverging step
    and the plain path's top-2 logit gap there)."""
    bad = [r.rid for (p, g), r in zip(work, reqs)
           if r.state is not RequestState.DONE or len(r.tokens) != g]
    if bad:
        raise AssertionError(f"fleet {name}: requests lost, failed or duplicated: {bad}")
    for i, (r, w) in enumerate(zip(reqs, want)):
        if r.tokens != w:
            step = next(j for j, (a, b) in enumerate(zip(r.tokens, w)) if a != b)
            emit({"phase": f"fleet_{name}", "ok": False, "request": i,
                  "first_diverging_step": step, "tokens": [r.tokens[step], w[step]],
                  "plain_top2_logit_gap": top2_gap(cfg32, params, work[i][0], w[:step])})
            raise AssertionError(f"fleet {name}: greedy stream {i} differs from one engine's")


def timed_handoffs(router):
    """Wrap every engine's handoff export and import in a synchronized
    timer; returns the list of seconds they append to."""
    secs = []

    def timed(fn):
        def call(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            return out
        return call

    for m in router.members:
        m.engine._export_slot = timed(m.engine._export_slot)
        m.engine._import_handoff = timed(m.engine._import_handoff)
    return secs


def phase_fleet(cfg, params):
    """The fleet slice on full-width tinyllama-1.1b (page 16, max_len 512, 8
    slots an engine).  fp32 greedy streams of FLEET_REQUESTS requests,
    each equal to one colocated paged engine's: (1) a disaggregated 1 + 1
    fleet, every counter zeroed just before and read just after: only the
    paged kernels, kernel 5 exactly 22 x the prefill engine's chunks,
    kernel 3 exactly 22 x the decode engine's steps and never on the
    prefill engine, the scatter once a layer per chunk and per decode
    step; the handoffs exactly the owned pages; (2) a colocated fleet of 2
    through rolling_restart(0) mid-stream; (3) FaultPlan.crash_engine on
    engine 0 under a FailurePolicy: ejected, probed, re-admitted, zero
    requests lost or duplicated.  Then (4) bf16 rates of FLEET_RATE_REQUESTS
    requests through the colocated and the disaggregated fleet,
    FLEET_ROUNDS rounds each: tokens/s, TTFT p50 and handoff ms a request
    (export + import, synchronized), medians, min and max; and (5)
    ``launch.serve.run --fleet 2 --disaggregate``.  Returns the
    disaggregated run's launches."""
    from repro_torch.core.resilience import FailurePolicy, FaultPlan, set_fault_injector
    from repro_torch.launch import serve as launch_serve

    t_phase = time.perf_counter()
    L = cfg.num_layers
    cfg32 = cfg.with_overrides(compute_dtype=torch.float32)
    work = mixed_requests(FLEET_REQUESTS, cfg.vocab_size, SEED + 13)
    eng = serve_engine(cfg32, params)
    ref = [eng.submit(p, max_new_tokens=g) for p, g in work]
    eng.run_until_drained()
    want = [r.tokens for r in ref]
    del eng

    # (1) disaggregated: the main path of this slice
    router = fleet(cfg32, params, "chip", disaggregate=True)
    torch.cuda.synchronize()
    zero_counts()
    reqs = [router.submit(Request(p, max_new_tokens=g)) for p, g in work]
    drained = router.drain(timeout=600)
    torch.cuda.synchronize()
    launches = read_counts()
    stats = router.stats()
    pre_eng, dec_eng = (m.engine for m in router.members)
    widths = sorted({T for T, _ in pre_eng._seen_shapes["prefill"]})
    page_bytes, pool_bytes = dec_eng._page_bytes, dec_eng._page_bytes * dec_eng.num_pages
    router.close()
    if not drained:
        raise AssertionError("the disaggregated fleet did not drain")
    fleet_streams_equal("disaggregated", cfg32, params, work, reqs, want)
    pre, dec_ = stats["engines"]
    owned = sum(-(-len(p) // PAGE) for p, _ in work)
    path = PATH_KERNELS["paged"]
    want_launches = {"prefill_attention_paged": L * pre["prefill_chunks"],
                     "decode_attention_paged": L * dec_["decode_steps"],
                     "paged_scatter": L * (pre["prefill_chunks"] + dec_["decode_steps"])}
    checks = {
        "launches_exact": all(launches[k] == v for k, v in want_launches.items()),
        "only_paged_kernels": all(v == 0 for k, v in launches.items() if k not in path),
        "prefill_engine_never_decodes": pre.get("decode_steps", 0) == 0,
        "decode_engine_never_prefills": dec_.get("prefill_chunks", 0) == 0,
        "handoffs": stats["handoffs_routed"] == len(work),
        "handoff_pages_owned": stats["handoff_pages"] == owned,
        "handoff_bytes_owned": stats["handoff_bytes"] == owned * page_bytes < pool_bytes}
    emit({"phase": "fleet_disaggregated", "ok": all(checks.values()), "arch": cfg.name,
          "compute_dtype": "torch.float32", "requests": len(work), "checks": checks,
          "launches": launches, "expected_launches": want_launches,
          "prefill_chunks": pre["prefill_chunks"], "decode_steps": dec_["decode_steps"],
          "prefill_widths": widths, "handoff_pages": stats["handoff_pages"],
          "handoff_bytes": stats["handoff_bytes"], "page_bytes": page_bytes,
          "pool_bytes": pool_bytes, "streams_equal_one_engine": True})
    if not all(checks.values()):
        raise AssertionError(f"fleet disaggregated checks failed: {checks}")

    # (2) rolling restart mid-stream
    router = fleet(cfg32, params, "chiprr")
    reqs = [router.submit(Request(p, max_new_tokens=g)) for p, g in work]
    t0 = time.time()
    while router.members[0].engine.occupancy() == 0 and time.time() - t0 < 120:
        time.sleep(0.002)
    busy = router.members[0].engine.occupancy()
    router.rolling_restart(0)
    drained = router.drain(timeout=600)
    stats = router.stats()
    router.close()
    if not (drained and busy):
        raise AssertionError(f"rolling restart: drained {drained}, engine 0 held {busy}")
    fleet_streams_equal("rolling_restart", cfg32, params, work, reqs, want)
    resumes = sum(e.get("resumes", 0) for e in stats["engines"])
    if not (stats["restarts"] == 1 and resumes >= 1):
        raise AssertionError(f"rolling restart: restarts {stats['restarts']}, resumes {resumes}")
    emit({"phase": "fleet_rolling_restart", "ok": True, "requests": len(work),
          "restarts": stats["restarts"], "resumes": resumes, "bound_at_restart": busy,
          "rerouted": stats.get("rerouted", 0), "streams_equal_one_engine": True})

    # (3) the breaker: crash, eject, probe, re-admit
    plan = FaultPlan(seed=SEED).crash_engine(engine="chipbk.eng0", at_step=3)
    inj = plan.injector()
    set_fault_injector(inj)
    try:
        router = fleet(cfg32, params, "chipbk",
                       router_kwargs={"policy": FailurePolicy(eject_after=1, probation_s=0.2)})
        reqs = [router.submit(Request(p, max_new_tokens=g)) for p, g in work]
        drained = router.drain(timeout=600)
        rng = np.random.default_rng(SEED + 14)
        deadline = time.time() + 60
        while time.time() < deadline:
            st = router.stats()
            if st.get("readmissions", 0) >= st.get("ejections", 0):
                break
            router.submit(Request(rng.integers(1, cfg.vocab_size, 4).astype(np.int32),
                                  max_new_tokens=2))
            router.drain(timeout=60)
            time.sleep(0.02)
        stats = router.stats()
        router.close()
    finally:
        set_fault_injector(None)
    if not drained:
        raise AssertionError("the breaker fleet did not drain")
    fleet_streams_equal("breaker", cfg32, params, work, reqs, want)
    snap = stats["breakers"]["chipbk.eng0"]
    checks = {"one_crash": stats.get("engine_crashes") == 1,
              "ejected_once": stats.get("ejections") == 1,
              "readmitted_by_probe": stats.get("readmissions") == 1
              and stats.get("probes_routed", 0) >= 1,
              "breaker_cycle": [t for t, _ in snap["transitions"]]
              == ["open", "half_open", "closed"],
              "one_fault_fired": len(inj.trace()) == 1}
    emit({"phase": "fleet_breaker", "ok": all(checks.values()), "checks": checks,
          "requests": len(work), "requests_recovered": stats.get("requests_recovered"),
          "recoveries": stats.get("recoveries"), "trace": [list(map(str, e))
                                                          for e in inj.trace()],
          "zero_lost_or_duplicated": True, "streams_equal_one_engine": True})
    if not all(checks.values()):
        raise AssertionError(f"fleet breaker checks failed: {checks}")

    # (4) rates in bf16
    rate_work = mixed_requests(FLEET_RATE_REQUESTS, cfg.vocab_size, SEED)
    rates = {}
    for kind, disaggregate in (("colocated", False), ("disaggregated", True)):
        runs = {"tokens_per_s": [], "ttft_ms_p50": [], "handoff_ms_per_request": []}
        for _ in range(FLEET_ROUNDS):
            router = fleet(cfg, params, f"rate{kind[0]}", disaggregate=disaggregate)
            for p, _ in rate_work[:2]:  # warm-up: cuBLAS, the first shapes
                router.submit(Request(p, max_new_tokens=4))
            router.drain(timeout=600)
            secs = timed_handoffs(router)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            reqs = [router.submit(Request(p, max_new_tokens=g)) for p, g in rate_work]
            drained = router.drain(timeout=600)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            router.close()
            if not drained or any(r.state is not RequestState.DONE for r in reqs):
                raise AssertionError(f"fleet {kind} rate run: requests not served")
            runs["tokens_per_s"].append(sum(len(r.tokens) for r in reqs) / wall)
            runs["ttft_ms_p50"].append(float(np.median([r.ttft_s for r in reqs])) * 1e3)
            runs["handoff_ms_per_request"].append(sum(secs) * 1e3 / len(reqs)
                                                  if disaggregate else None)
        rates[kind] = {k: {"runs": v, "median": float(np.median(v)), "min": min(v),
                           "max": max(v)} if v[0] is not None else None
                       for k, v in runs.items()}
    emit({"phase": "fleet_rates", "ok": True, "arch": cfg.name, "gpu": gpu_line(),
          "compute_dtype": str(cfg.compute_dtype), "requests": FLEET_RATE_REQUESTS,
          "rounds": FLEET_ROUNDS, **rates})

    # (5) the serving driver's fleet gateway
    res = launch_serve.run(launch_serve.build_parser().parse_args(
        ["--arch", ARCH, "--fleet", "2", "--disaggregate", "--batch", "8", "--quiet"]))
    if not (res["handoffs"] == 8 and res["generated_tokens"] == 8 * 16):
        raise AssertionError(f"launch.serve --fleet 2 --disaggregate: {res}")
    emit({"phase": "fleet_launch_serve", "ok": True, "tokens_per_s": res["tokens_per_s"],
          "ttft_p50_s": res["ttft_p50_s"], "handoffs": res["handoffs"],
          "seconds": time.perf_counter() - t_phase})
    torch.cuda.empty_cache()
    return launches


def fleet_prefill_rows(cfg, launches):
    """Kernel 5 at the fleet's prefill widths (T 128, 256, 512; B 8 whole
    prompts at base 0, fleet_chunk_lens; bf16; one input set per layer),
    with its bound and SDPA beside, in the kernel table's format; its
    launches are the fleet phase's."""
    from repro_torch.models.lm import serving_attention_shapes

    dt = cfg.compute_dtype
    esz = torch.finfo(dt).bits // 8
    L, B, mp = cfg.num_layers, SERVE["max_slots"], MAX_LEN // PAGE
    H, KV, D = serving_attention_shapes(cfg)["prefill_attention_paged"]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    out = []
    for T in FLEET_T:
        base, clens = [0] * B, fleet_chunk_lens(T, B)
        cases = [prefill_case(gen, T, H, KV, D, mp, base, clens, dt) for _ in range(L)]
        err = max(check_prefill(a)[0] for a in cases[:2])
        lib = [sdpa_inputs(q.transpose(1, 2).contiguous(), kp, vp, bt,
                           causal_mask(bs, T, mp * PAGE), H, KV)
               for q, kn, vn, kp, vp, bt, bs, cl in cases]
        nxt, lib_nxt = rotate(cases), rotate(lib)
        fn, plain = pf.prefill_attention_paged_kernel, pf.prefill_attention_paged_plain
        row = kernel_row(
            "prefill_attention_paged", "src/repro/kernels/prefill_attention.py:222",
            launches, err, cuda_ms(lambda: fn(*nxt())), cuda_ms(lambda: plain(*nxt())),
            prefill_bytes(base, clens, T, B, H, KV, D, esz, 4 * B * (mp + 2)),
            prefill_flops(base, clens, H, D), cuda_ms(lambda: sdpa(*lib_nxt())), PAGED_SDPA,
            {"B": B, "T": T, "H": H, "KV": KV, "D": D, "page": PAGE, "max_pages": mp,
             "base": base, "chunk_lens": clens, "arch": cfg.name, "dtype": str(dt)},
            lib_us=device_us_per_call(lambda: sdpa(*lib_nxt()))[0])
        row["device_us_per_launch"] = device_us_per_call(lambda: fn(*nxt()), reps=2 * L)[0]
        out.append(row)
        del cases, lib
    emit({"phase": "timing", "ok": True, "arch": cfg.name, "fleet_prefill": True,
          "rows": out})
    return out


def shape_rows(cfg, launches, shapes, kernels):
    """Rows of the kernel table's format for ``kernels`` at the serving
    shapes ``cfg``'s path gives them (the timing phase's inputs: B 8, the
    run's lengths and page buckets, one input set per layer), with SDPA
    beside: these are further launch shapes of rows already in the
    table."""
    from repro_torch.models.lm import serving_attention_shapes

    dt = cfg.compute_dtype
    esz = torch.finfo(dt).bits // 8
    L, B = cfg.num_layers, 8
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    at_shape = serving_attention_shapes(cfg)
    out = []
    for kernel in kernels:
        H, KV, D = at_shape[kernel]
        # the run's requests in the first slots, the other slots empty (as
        # the decode step gives them: length 0, nothing read)
        run_lens = (shapes["contiguous"]["lens"] + [0] * B)[:B]
        if kernel == "decode_attention":
            S = MAX_LEN
            lens = [min(n, S) for n in run_lens]
            cases = [contig_decode_case(gen, H, KV, D, S, lens, dt) for _ in range(L)]
            err = max(check_contig_decode(a)[0] for a in cases[:2])
            fn, plain = dec.decode_attention_kernel, dec.decode_attention_plain
            lib = [contig_sdpa_inputs(
                q[:, :, None], k, v,
                (torch.arange(S, device="cuda")[None, :] < cl[:, None])[:, None, None, :],
                H, KV) for q, k, v, cl in cases]
            live = sum(lens)
            bytes_ = 2 * live * KV * D * esz + 2 * B * H * D * esz + 4 * B
            flops, note, replaces = 4 * H * D * live, CONTIG_SDPA, "decode_attention.py:114"
            at = {"B": B, "H": H, "KV": KV, "D": D, "S": S, "cache_len": lens}
        elif kernel == "decode_attention_paged":
            mb = shapes["paged"]["decode_mb"]
            lens = [min(n, mb * PAGE) for n in run_lens]
            cases = [decode_case(gen, H, KV, D, mb, lens, dt) for _ in range(L)]
            err = max(check_decode(a)[0] for a in cases[:2])
            fn, plain = dec.decode_attention_paged_kernel, dec.decode_attention_paged_plain
            lib = [sdpa_inputs(q[:, :, None], kp, vp, bt,
                               (torch.arange(mb * PAGE, device="cuda")[None, :]
                                < cl[:, None])[:, None, None, :], H, KV)
                   for q, kp, vp, bt, cl in cases]
            live = sum(lens)
            bytes_ = 2 * live * KV * D * esz + 2 * B * H * D * esz + 4 * B * (mb + 1)
            flops, note, replaces = 4 * H * D * live, PAGED_SDPA, "decode_attention.py:199"
            at = {"B": B, "H": H, "KV": KV, "D": D, "page": PAGE, "max_pages": mb,
                  "cache_len": lens}
        else:  # prefill_attention_paged: a 64-token chunk at base 64, the rest inert
            T, mbp = shapes["paged"]["prefill_T_mb"]
            base, clens = [64] + [0] * (B - 1), [T] + [0] * (B - 1)
            cases = [prefill_case(gen, T, H, KV, D, mbp, base, clens, dt) for _ in range(L)]
            err = max(check_prefill(a)[0] for a in cases[:2])
            fn, plain = pf.prefill_attention_paged_kernel, pf.prefill_attention_paged_plain
            lib = [sdpa_inputs(q.transpose(1, 2).contiguous(), kp, vp, bt,
                               causal_mask(bs, T, mbp * PAGE), H, KV)
                   for q, kn, vn, kp, vp, bt, bs, cl in cases]
            bytes_ = prefill_bytes(base, clens, T, B, H, KV, D, esz, 4 * B * (mbp + 2))
            flops = prefill_flops(base, clens, H, D)
            note, replaces = PAGED_SDPA, "prefill_attention.py:222"
            at = {"B": B, "T": T, "H": H, "KV": KV, "D": D, "page": PAGE, "max_pages": mbp,
                  "base": base, "chunk_lens": clens}
        nxt, lib_nxt = rotate(cases), rotate(lib)
        row = kernel_row(
            kernel, f"src/repro/kernels/{replaces}", launches, err,
            cuda_ms(lambda: fn(*nxt())), cuda_ms(lambda: plain(*nxt())), bytes_, flops,
            cuda_ms(lambda: sdpa(*lib_nxt())), note,
            {**at, "arch": cfg.name, "dtype": str(dt)},
            lib_us=device_us_per_call(lambda: sdpa(*lib_nxt()))[0])
        row["device_us_per_launch"] = device_us_per_call(lambda: fn(*nxt()), reps=2 * L)[0]
        out.append(row)
        del cases, lib
    emit({"phase": "timing", "ok": True, "arch": cfg.name, "rows": out})
    return out


def phase_mla_moe():
    """minicpm3-4b (MLA, fp32 parameters, fp32 streams held kernel path
    to plain path) and moonshot-v1-16b-a3b (MoE, bf16 parameters) served
    at their published widths, one after the other (serve_family); then
    kernel 2 timed at the MLA serving shape and kernels 3 and 5 at
    moonshot's (shape_rows).  Returns each phase's launches per kernel
    and the rows."""
    cfg, launches, shapes = serve_family(MLA, stream=True)
    mla_launches = {k: sum(launches[layout][k] for layout in LAYOUTS) for k in COUNTED}
    rows = shape_rows(cfg, mla_launches, shapes, ("decode_attention",))
    cfg, launches, shapes = serve_family(MOE, param_dtype=MOE_PARAM_DTYPE)
    moe_launches = {k: sum(launches[layout][k] for layout in LAYOUTS) for k in COUNTED}
    rows += shape_rows(cfg, moe_launches, shapes,
                       ("decode_attention_paged", "prefill_attention_paged"))
    torch.cuda.empty_cache()
    return {"mla": mla_launches, "moe": moe_launches}, rows


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


def flash_row(cfg, launches, device_us, lib_us):
    """The flash kernel's timing row at the training shape, rotating over
    one input set per layer; ``lib_us``: SDPA's device us per call at that
    shape (profile_new_kernels)."""
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
                      "layout": "[B,S,H,D] viewed as [B,H,S,D]", "dtype": str(dt)},
                     lib_us=lib_us)
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
    ``fn`` (device_window); a symbol that never launched fails."""
    by_name = device_window(fn, reps)
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
    top = sorted(device_window(fn, 1).items(), key=lambda kv: -kv[1][0])[:n]
    return [{"name": k[:90], "ms": v[0], "launches": v[1]} for k, v in top] or None


def profile_new_kernels():
    """Device us per launch of kernels 6 and 7 at their paths' shapes
    (rmsnorm on [4096, 2048] bf16; the hash on [8, 2^23] keys in
    [0, 2^20), 8 buckets), and the device us per call of the library
    yardsticks of kernels 1 and 6 at the rows' shapes (SDPA at the
    training shape, F.rms_norm), early in the run: windows opened after
    the training, dataframe and pipeline phases came back without device
    events."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    (x, w), = rms_cases(gen, 1)
    keys = torch.randint(0, DF_KEYS, (DF_SHARDS, DF_ROWS // DF_SHARDS), generator=gen,
                         device="cuda", dtype=torch.int32)
    (rms_symbol,), (hash_symbol,) = SYMBOLS["rmsnorm"], SYMBOLS["hash_partition_histogram"]
    # the yardsticks rotate over four input sets, as their rows' timings
    # do, so their inputs are not served from L2
    cfg = get_config(ARCH)
    G = cfg.num_heads // cfg.num_kv_heads
    attn = rotate([(q, k.repeat_interleave(G, 1), v.repeat_interleave(G, 1))
                   for q, k, v in (flash_case(gen, TRAIN_B, cfg.num_heads, cfg.num_kv_heads,
                                              TRAIN_S, cfg.head_dim, cfg.compute_dtype)
                                   for _ in range(4))])
    norms = rotate(rms_cases(gen, 4))

    def norm():
        x, w = norms()
        return F.rms_norm(x, x.shape[-1:], w, eps=1e-5)

    return {"rmsnorm": profiled_us(lambda: rms.rmsnorm_kernel(x, w), (rms_symbol,))[rms_symbol],
            "hash_partition_histogram": profiled_us(
                lambda: hp.hash_partition_histogram_kernel(keys, num_buckets=DF_SHARDS),
                (hash_symbol,), reps=3)[hash_symbol],
            "flash_attention_library": device_us_per_call(
                lambda: F.scaled_dot_product_attention(*attn(), is_causal=True))[0],
            "rmsnorm_library": device_us_per_call(norm)[0]}


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
    """tests/test_system.py's pipeline at 2^26 rows, as a Pipeline of a
    ``cylon_stage`` and two ``dl_stage``s under the port's run_pipelines on
    a pilot over the card: filter, the zero-copy loader (shuffled), SGD on
    a linear model, postprocess; then the host prefetcher over host
    batches."""
    from repro_torch.core.bridge import cylon_stage, data_bridge, dl_stage
    from repro_torch.core.pipeline import Pipeline, run_pipelines

    t_phase = time.perf_counter()

    def preprocess(comm, upstream):
        cols, valid = filter_rows(t.columns, t.valid, t.col("x1").abs() < 3.0)
        return t.with_columns({c: cols[c] for c in ("x1", "x2", "y")}, valid)

    def train(comm, upstream):
        loader = data_bridge(upstream["preprocess"], ["x1", "x2"], "y", PIPE_BATCH,
                             shuffle=True, seed=SEED)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batches = sum(1 for _ in loader.epoch(0))
        torch.cuda.synchronize()
        loader_s = time.perf_counter() - t0
        w = torch.zeros(2, device=comm.device, requires_grad=True)
        b = torch.zeros((), device=comm.device, requires_grad=True)
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
        return {"w": w.detach().cpu(), "b": float(b.detach()), "losses": losses,
                "loader_batches": batches, "loader_s": loader_s,
                "train_s": time.perf_counter() - t0,
                "valid_rows": int(upstream["preprocess"].valid.sum())}

    def postprocess(comm, upstream):
        r = upstream["train"]
        w_err = float((r["w"] - torch.tensor([3.0, -2.0])).abs().max())
        return {"w_err": w_err, "first10_mean_loss": float(np.mean(r["losses"][:10])),
                "last10_mean_loss": float(np.mean(r["losses"][-10:]))}

    pipe = Pipeline("pipeline", [
        cylon_stage("preprocess", preprocess),
        dl_stage("train", train, deps=("preprocess",)),
        dl_stage("postprocess", postprocess, deps=("train",), kind="inference")])
    out = run_pipelines([pipe], max_workers=2)
    if "_error" in out["pipeline"]:
        raise AssertionError(f"pipeline stage failed: {out['pipeline']['_error']}")
    r, post = out["pipeline"]["train"], out["pipeline"]["postprocess"]
    w_err, first, last = post["w_err"], post["first10_mean_loss"], post["last10_mean_loss"]
    if not (w_err < 0.2 and last < first and np.isfinite(r["losses"]).all()):
        raise AssertionError(f"pipeline did not learn: w_err {w_err}, loss {first} -> {last}")
    meta = out["_meta"]

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
          "runtime": "run_pipelines: cylon_stage >> dl_stage >> dl_stage",
          "runtime_overheads": meta["per_pipeline"]["pipeline"],
          "valid_rows": r["valid_rows"], "global_batch": PIPE_BATCH,
          "loader_batches": r["loader_batches"], "loader_s": r["loader_s"],
          "loader_rows_per_s": r["loader_batches"] * PIPE_BATCH / r["loader_s"],
          "train_steps": PIPE_STEPS, "train_s": r["train_s"],
          "train_steps_per_s": PIPE_STEPS / r["train_s"],
          "first10_mean_loss": first, "last10_mean_loss": last,
          "w": r["w"].tolist(), "b": r["b"], "w_err": w_err,
          "prefetch_batches": len(got), "prefetch_bytes": nbytes,
          "prefetch_s": prefetch_s, "prefetch_gb_per_s": nbytes / prefetch_s / 1e9,
          "seconds": time.perf_counter() - t_phase})


def phase_runtime(cfg):
    """The port's two main paths through its pilot runtime.  First the
    training entry point ``launch.train.run``, its stage graph (preprocess >>
    train >> postprocess) under a Session over the card at full width,
    B 8 x S 512, RUNTIME_STEPS steps, its checkpoint in a temporary
    directory removed afterwards: every counter zeroed just before and
    read just after, flash attention exactly 2 x layers per step, no
    other kernel.  Then a paged fp32 ServeEngine as a service stage
    (``session.serve``), RUNTIME_REQUESTS greedy requests through the
    ServiceHandle, then drain: each request's tokens equal the same
    engine's ``run_until_drained`` on the same weights, and the paged
    kernels alone launch.  Returns the launches of both runs."""
    from repro_torch.core import Session, stage
    from repro_torch.core.task import TaskState
    from repro_torch.launch import train as launch_train
    from repro_torch.serve import Request

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as ckdir:
        args = launch_train.build_parser().parse_args(
            ["--arch", ARCH, "--steps", str(RUNTIME_STEPS), "--batch", str(TRAIN_B),
             "--seq", str(TRAIN_S), "--ckpt-dir", ckdir])
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        res = launch_train.run(args)
        torch.cuda.synchronize()
        train_wall = time.perf_counter() - t0
        train_launches = read_counts()
        ckpt_step = store.latest_step(ckdir)
    want = 2 * cfg.num_layers * RUNTIME_STEPS
    if train_launches["flash_attention"] != want:
        raise AssertionError(f"the training entry point launched flash {train_launches['flash_attention']} "
                             f"times, expected {want}")
    others = {n: c for n, c in train_launches.items() if n not in PATH_KERNELS["train"]}
    if any(others.values()):
        raise AssertionError(f"the training entry point launched other kernels: {others}")
    if not (res["improved"] and np.isfinite([res["first_loss"], res["last_loss"]]).all()
            and res["steps"] == RUNTIME_STEPS and ckpt_step == RUNTIME_STEPS):
        raise AssertionError(f"the training entry point did not learn or save: {res}, "
                             f"checkpoint step {ckpt_step}")
    torch.cuda.empty_cache()

    # the service stage, fp32 compute, against the same engine run directly
    cfg32 = cfg.with_overrides(compute_dtype=torch.float32)
    params = init_params(torch.Generator(device="cuda").manual_seed(SEED),
                         model_specs(cfg32), "cuda")
    work = mixed_requests(RUNTIME_REQUESTS, cfg.vocab_size, SEED + 2)
    direct = serve_engine(cfg32, params, kv_layout="paged")
    direct_reqs = [direct.submit(p, max_new_tokens=g) for p, g in work]
    direct.run_until_drained()
    eng = serve_engine(cfg32, params, kv_layout="paged")

    @stage(kind="inference", service=True)
    def engine(ctx):
        return eng.run_service(ctx.control, resume_state=ctx.resume_state)

    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    with Session() as session:
        handle = session.serve(engine, name="serve")
        reqs = [handle.submit_request(Request(p, max_new_tokens=g)) for p, g in work]
        drained = handle.stop(drain=True, timeout=600)
        task = handle.task
        placement = handle.pipeline.stage_placements()
    torch.cuda.synchronize()
    serve_wall = time.perf_counter() - t0
    serve_launches = read_counts()
    if not drained or task.state is not TaskState.DONE:
        raise AssertionError(f"the service stage ended {task.state}: {task.error}")
    bad = [r.rid for r, d in zip(reqs, direct_reqs)
           if r.state is not RequestState.DONE or r.tokens != d.tokens]
    if bad:
        raise AssertionError(f"service streams differ from the direct engine's: {bad}")
    paged = PATH_KERNELS["paged"]
    if min(serve_launches[n] for n in paged) <= 0 or any(
            c for n, c in serve_launches.items() if n not in paged):
        raise AssertionError(f"the service stage's launches: {serve_launches}")
    if serve_launches["paged_scatter"] != (serve_launches["decode_attention_paged"]
                                           + serve_launches["prefill_attention_paged"]):
        raise AssertionError("the paged scatter did not launch once per prefill call "
                             "and decode append")
    stats = task.result
    del params, direct, eng
    torch.cuda.empty_cache()
    emit({"phase": "runtime", "ok": True, "gpu": gpu_line(),
          "train": {"entry": "repro_torch.launch.train.run", "arch": cfg.name,
                    "layers": cfg.num_layers, "batch": TRAIN_B, "seq": TRAIN_S,
                    "steps": res["steps"], "first_loss": res["first_loss"],
                    "last_loss": res["last_loss"], "improved": res["improved"],
                    "train_s": res["train_s"], "wall_s": train_wall,
                    "overheads_s": res["overheads"], "placement": res["placement"],
                    "checkpoint_step": ckpt_step, "launches": train_launches},
          "service": {"entry": "Session.serve(ServeEngine.run_service)",
                      "kv_layout": "paged", "compute_dtype": "torch.float32",
                      "requests": len(reqs), "tokens": sum(len(r.tokens) for r in reqs),
                      "equal_to_run_until_drained": True, "wall_s": serve_wall,
                      "task_state": task.state.value,
                      "overheads_s": {**task.overhead_s, "execute": task.duration_s},
                      "placement": placement, "completed": stats["completed"],
                      "decode_steps": stats["decode_steps"],
                      "prefill_chunks": stats["prefill_chunks"],
                      "launches": serve_launches},
          "seconds": time.perf_counter() - t_phase})
    return train_launches, serve_launches


def profile_paper_step(step, steps: int):
    """``steps`` calls of ``step()`` (one SGD step each) under
    torch.profiler: wall and device busy ms per step, the device's idle
    share, device kernels and top-level aten ops per step."""
    from torch.profiler import ProfilerActivity, profile

    step()  # warm: cuBLAS handles, allocator
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            loss = step()
        loss.item()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels, by_name = device_kernels(prof)
    busy_ms = sum(v[0] for v in by_name.values())
    cpu_ops = sum(1 for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CPU
                  and e.name.startswith("aten::") and e.cpu_parent is None)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    return {"steps": steps, "wall_ms_per_step": wall_ms / steps,
            "device_busy_ms_per_step": busy_ms / steps,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "gpu_kernels_per_step": len(kernels) / steps,
            "device_us_per_kernel": 1e3 * busy_ms / max(len(kernels), 1),
            "top_level_aten_ops_per_step": cpu_ops / steps,
            "top_kernels": [{"name": k[:80], "ms": v[0], "launches": v[1]}
                            for k, v in top]}


def phase_paper():
    """The paper's tables on the card (``launch.paper_tables`` at the JAX
    package's default sizes): Table 3, the 11 forecasting models trained
    bare-metal and as a RemoteAgent task (60 steps each); Tables 1-2, the
    hydrology LSTM (150 steps, 2000 days); Table 4, 11 pipelines of a
    cylon_stage sort and a dl_stage inference under one pilot against
    sequential.  Every task DONE, every metric finite, validation NNSE
    above 0.5 for NNSE_TARGETS, no port kernel launched (the models reach
    none).  Then a profile of PAPER_PROFILE_STEPS SGD steps of the GRU and
    of the LSTM at the benchmark's shapes."""
    from repro_torch.common import prng
    from repro_torch.launch import paper_tables as pt
    from repro_torch.models import forecasting as fm
    from repro_torch.models import hydrology as hm

    t_phase = time.perf_counter()
    zero_counts()
    t0 = time.perf_counter()
    fc = pt.bench_forecasting()
    fc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    hy = pt.bench_hydrology()
    hy_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mp = pt.bench_multi_pipeline()
    mp_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = read_counts()
    if any(launches.values()):
        raise AssertionError(f"the paper's models launched port kernels: {launches}")
    states = ([r["state"] for r in fc.values()] + [hy["state"]]
              + list(mp["task_states"].values()))
    if set(states) != {"done"} or mp["meta"]["n_failed"]:
        raise AssertionError(f"tasks not DONE: {states}")
    numbers = ([v for r in fc.values() for run in ("bm", "rc") for v in r[run].values()]
               + [v for m in hy["metrics"].values() for v in m.values()]
               + [hy["bm_train_s"], hy["rc_total_s"], mp["bm_s"], mp["rc_s"]])
    if not np.isfinite(numbers).all():
        raise AssertionError("a paper metric is not finite")
    low = {t: hy["metrics"][t]["val_nnse"] for t in NNSE_TARGETS
           if not hy["metrics"][t]["val_nnse"] > 0.5}
    if low:
        raise AssertionError(f"validation NNSE not above 0.5: {low}")

    # the seeded draws on the card are JAX's: the ETT series against a
    # numpy reference built from threefry_np's bits
    ett = check_ett_series(fm)
    # where a step's time goes: the eager GRU (96 time steps) and LSTM (64)
    init, apply = fm.MODELS["GRU"](96, 24)
    gru = pt._trainable(init(prng.PRNGKey(SEED), "cuda"))
    series = fm.make_ett_series(4096, device="cuda")
    starts = prng.randint(prng.PRNGKey(SEED + 1), 128, 0, 3 * 4096 // 4 - 120).cuda().long()
    feats, targets = hm.make_camels_like(2000, device="cuda")
    x_all, y_all = hm.window_dataset(feats, targets, 64)
    lstm = pt._trainable(hm.lstm_init(prng.PRNGKey(SEED), device="cuda"))
    idx = prng.randint(prng.PRNGKey(SEED + 2), 64, 0, x_all.shape[0]).cuda().long()
    profiles = {
        "GRU": profile_paper_step(lambda: pt.forecaster_step(
            apply, gru, series, starts, 96, 24, 1e-3), PAPER_PROFILE_STEPS),
        "LSTM": profile_paper_step(lambda: pt.hydrology_step(lstm, x_all, y_all, idx),
                                   PAPER_PROFILE_STEPS)}
    emit({"phase": "paper_table3", "ok": True, "gpu": gpu_line(), "seconds": fc_s,
          "models": {name: {"steps": r["steps"], "bm_train_s": r["bm"]["train_s"],
                            "rc_total_s": r["rc_total_s"], "overhead_s": r["overhead_s"],
                            "task_overheads_s": r["task_overheads"], "state": r["state"],
                            **{k: r["bm"][k] for k in ("MAE", "MSE", "MAPE", "loss")}}
                     for name, r in fc.items()}})
    emit({"phase": "paper_tables12", "ok": True, "gpu": gpu_line(), "seconds": hy_s,
          **{k: hy[k] for k in ("steps", "days", "bm_train_s", "rc_train_s", "rc_total_s",
                                "overhead_s", "task_overheads", "state", "metrics")}})
    emit({"phase": "paper_table4", "ok": True, "gpu": gpu_line(), "seconds": mp_s,
          **{k: mp[k] for k in ("n_pipelines", "bm_s", "rc_s", "saved_s", "meta")}})
    emit({"phase": "paper_profile", "ok": True, "gpu": gpu_line(), "launches": launches,
          "ett_series": ett, "profiles": profiles,
          "seconds": time.perf_counter() - t_phase})


def check_ett_series(fm, n=4096, seeds=(0, 3)):
    """``make_ett_series`` on the card against numpy: the noise's bits
    exactly against threefry_np (key [0, seed], counters 0 .. n-1), the
    standardized series within ETT_TOL of a reference that draws the
    normals from those bits in float64 (scipy's erfinv) and computes the
    seasonal terms in float32 as both packages do."""
    from scipy.special import erfinv

    from repro_torch.common import prng

    out = {}
    for seed in seeds:
        key = np.array([0, seed & 0xFFFFFFFF], np.uint32)
        with np.errstate(over="ignore"):
            w1, w2 = threefry_np(key[0], key[1], np.zeros(n, np.uint32),
                                 np.arange(n, dtype=np.uint32))
        bits = w1 ^ w2
        got_bits = prng.random_bits(prng.PRNGKey(seed), n, device="cuda").cpu().numpy()
        floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - 1.0
        lo = np.float64(np.nextafter(np.float32(-1), np.float32(0)))
        noise = np.sqrt(2.0) * erfinv(np.maximum(lo, floats.astype(np.float64) * 2.0 + lo))
        t = np.arange(n, dtype=np.float32)
        series = (np.sin(2 * np.pi * t / 24.0) + 0.5 * np.sin(2 * np.pi * t / (24.0 * 7))
                  + 0.3 * np.sin(2 * np.pi * t / 96.0 + 1.0) + 0.0005 * t).astype(np.float64)
        series = series + 0.2 * noise
        want = (series - series.mean()) / series.std()
        got = fm.make_ett_series(n, seed=seed, device="cuda").cpu().numpy()
        err = float(np.abs(got - want).max())
        out[seed] = {"bits_equal": bool(np.array_equal(got_bits, bits)), "max_abs_err": err,
                     "tol": ETT_TOL}
        if not (out[seed]["bits_equal"] and err <= ETT_TOL):
            raise AssertionError(f"make_ett_series on the card is not JAX's: {out[seed]}")
    return out


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


def rmsnorm_row(launches, device_us, lib_us):
    """Kernel 6 at the training activations' shape, rotating over four
    input sets (134 MB with the outputs, past the 50 MB L2); ``lib_us``:
    F.rms_norm's device us per call (profile_new_kernels)."""
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
                     flops_per_s=FP32_FLOPS_PER_S, lib_us=lib_us)
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
    if ARGS.compare:
        phase_compare(ARGS.compare)
        return 0
    wall = {}
    clock = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        wall[name] = now - clock[0]
        clock[0] = now

    phase_build()
    lap("build")
    phase_kernels()
    new_us = profile_new_kernels()
    lap("kernels")
    cfg = get_config(ARCH)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = init_params(gen, model_specs(cfg), "cuda")
    launches, shapes = serve_rounds(cfg, params, SERVE_ROUNDS)
    lap("serve")
    rows = phase_timing(cfg, launches, shapes)
    lap("timing")
    device_us = {}
    for layout in LAYOUTS:
        device_us.update(phase_profile(cfg, params, layout))
    for row in rows:  # the paged prefill's is taken at its timing shape
        row.setdefault("device_us_per_launch", device_us[row["name"]])
    lap("profile")
    phase_stream(cfg, params)
    lap("stream")
    phase_sampling(cfg, params)
    lap("sampling")
    fleet_launches = phase_fleet(cfg, params)
    fleet_rows = fleet_prefill_rows(cfg, fleet_launches)
    del params
    torch.cuda.empty_cache()
    lap("fleet")
    phase_phi3()
    lap("phi3")
    family_launches, family_rows = phase_mla_moe()
    lap("mla_moe")
    flash_launches, flash_us = phase_train(cfg)
    torch.cuda.empty_cache()
    lap("train")
    phase_train_parity(cfg)
    lap("train_parity")
    rt_train, rt_serve = phase_runtime(cfg)
    lap("runtime")
    # the serving rows count the launches of every main path that runs
    # them: the fleet phase's disaggregated run, the runtime phase's
    # service stage, the MLA and MoE phases; and carry their timings at
    # the MLA and MoE serving shapes and the fleet's prefill widths
    for row in rows:
        by_phase = {"serve": row["launches"], "fleet": fleet_launches.get(row["name"], 0),
                    "runtime": rt_serve.get(row["name"], 0),
                    **{k: v[row["name"]] for k, v in family_launches.items()}}
        if any(v for k, v in by_phase.items() if k != "serve"):
            row["launches_by_phase"] = by_phase
            row["launches"] = sum(by_phase.values())
        row["at_other_shapes"] = [r for r in family_rows + fleet_rows
                                  if r["name"] == row["name"]]
    rows.append(flash_row(cfg, {"flash_attention": flash_launches
                                + rt_train["flash_attention"]}, flash_us,
                          new_us["flash_attention_library"]))
    rows[-1]["launches_by_phase"] = {"train": flash_launches,
                                     "runtime": rt_train["flash_attention"]}
    torch.cuda.empty_cache()
    host_cols, table, hash_launches = phase_dataframe()
    lap("dataframe")
    phase_pipeline(table, host_cols)
    del table, host_cols
    torch.cuda.empty_cache()
    lap("pipeline")
    rows.append(rmsnorm_row({"rmsnorm": phase_rmsnorm(cfg)}, new_us["rmsnorm"],
                            new_us["rmsnorm_library"]))
    rows.append(hash_row({"hash_partition_histogram": hash_launches},
                         new_us["hash_partition_histogram"]))
    emit({"phase": "timing", "ok": True, "rows": rows[-3:]})
    lap("rmsnorm")
    phase_paper()
    lap("paper")
    emit({"phase": "wall", "ok": True, "seconds": wall, "total_s": sum(wall.values())})
    print(gpu_line(), flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
