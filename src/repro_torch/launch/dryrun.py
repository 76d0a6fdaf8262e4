"""Dry run on the meta device (mirror of ``repro.launch.dryrun``): every
(arch x shape x mesh) cell's step runs once on meta tensors, through the
plain ops, with no memory allocated and no host read, and its work is
counted.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
      --subprocess-per-cell

Each cell writes one JSON file (``--out``, default ``results/dryrun_torch``)
with, per device of the production mesh (``launch.mesh.make_production_mesh``):

* ``flops``: ``matmul_flops`` (``torch.utils.flop_counter.FlopCounterMode``)
  plus ``elementwise_flops``, one FLOP per output element of every other op
  that writes a floating-point tensor (views and empty allocations write
  none).  This is ``distributed/hlo_analysis.py``'s rule in the JAX package
  (+1 FLOP per element of every materializing instruction), applied per op
  because eager PyTorch does not fuse.  ``attention_flops`` is the share of
  ``matmul_flops`` in the attention products: the plain path computes the
  full S x S square where the kernels stop at the causal frontier.
  ``model_flops`` is ``flops`` of the same step without remat.
* ``memory``: argument, output and donated bytes, exact from the spec trees
  and the mesh; ``peak_live_bytes_estimate``, the largest sum of live meta
  storages during the step (every storage from its first write until it is
  freed), and its share per device.
* ``collective_bytes_per_device`` under ``COLLECTIVE_MODEL``.
* ``roofline`` under the H100 SXM model below (``compute_s``, ``memory_s``,
  ``collective_s``, ``dominant``) and ``fits_80gb``.

Numbers are per device: the step runs once at the global shapes, and the
counts are divided by the number of cards (a perfectly even split).  The
``global`` entry holds the undivided integer counts.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
import threading
import time
import traceback
import weakref
from typing import Any, Dict

import torch
import torch.utils.checkpoint
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch.configs import (
    ARCHS, SHAPES, SMOKE_SHAPES, default_run_config, get_config, shape_applicable,
)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import input_specs
from repro_torch.train.step import make_decode_step, make_prefill_step, make_train_step

# NVIDIA H100 SXM model, per card
PEAK_FLOPS_BF16 = 989e12    # dense tensor-core FLOP/s
PEAK_FLOPS_FP32 = 67e12     # CUDA cores, no TF32
HBM_BW = 3.35e12            # bytes/s
HBM_PER_CARD = 80e9         # bytes
CARDS_PER_NODE = 8
NVLINK_BW = 450e9           # bytes/s per direction, inside a node
IB_BW = 50e9                # bytes/s per card, between nodes

HARDWARE = {
    "card": "H100 SXM (model; no such cluster was run)",
    "peak_flops_bf16": PEAK_FLOPS_BF16, "peak_flops_fp32": PEAK_FLOPS_FP32,
    "hbm_bytes_per_s": HBM_BW, "hbm_bytes": HBM_PER_CARD,
    "cards_per_node": CARDS_PER_NODE, "nvlink_bytes_per_s": NVLINK_BW,
    "infiniband_bytes_per_s": IB_BW,
}
FLOP_RULE = ("matmul FLOPs from FlopCounterMode, plus 1 FLOP per output element of "
             "every other op writing a floating-point tensor (no view, no empty "
             "allocation); hlo_analysis's rule applied per eager op")
COMPUTE_MODEL = ("matmul FLOPs at the compute dtype's peak (bf16 989e12, fp32 67e12), "
                 "the other FLOPs at the fp32 CUDA-core peak (67e12)")
BYTES_MODEL = "every non-view op reads each tensor input once and writes each output once"
COLLECTIVE_MODEL = (
    "FSDP: every parameter leaf sharded by its spec is all-gathered over the mesh "
    "axes it is sharded on, once per forward of a microbatch (twice under remat: "
    "the recompute), and a training step reduce-scatters its gradient over the same "
    "axes once; a device moves (f - 1) / f of the leaf's bytes per collective, f "
    "the leaf's shard count.  Tensor-parallel activation collectives are not "
    "counted.  A group inside one node of 8 (innermost axes, 8 cards or fewer) "
    "runs at NVLink's rate, any other at InfiniBand's")
MEMORY_MODEL = ("arguments, outputs and donations as their specs shard them; the "
                "rest of the live peak split evenly over the cards")

_ATTENTION = "dryrun_attention"
_CHECKPOINT_FILE = torch.utils.checkpoint.__file__
_aten = torch.ops.aten
# allocations that write nothing
_EMPTY = {_aten.empty, _aten.empty_like, _aten.empty_strided, _aten.new_empty,
          _aten.new_empty_strided}


# ---------------------------------------------------------------------------
# The counters
# ---------------------------------------------------------------------------


def _attention_codes() -> frozenset:
    """The code objects of the attention entry points the models call
    (and of the functions nested in them, e.g. ``chunked_attention``'s
    checkpointed ``kv_body``): a matmul run under one of them is an
    attention product."""
    from repro_torch.kernels import ops
    from repro_torch.models import blocks

    fns = (ops.flash_attention, ops.decode_attention, ops.decode_attention_paged,
           ops.prefill_attention, ops.prefill_attention_paged, blocks.chunked_attention)
    out, todo = set(), [f.__code__ for f in fns]
    while todo:
        code = todo.pop()
        out.add(code)
        todo.extend(c for c in code.co_consts if hasattr(c, "co_consts"))
    return frozenset(out)


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Counter(TorchDispatchMode):
    """Counts, op by op: the FLOPs of non-matmul ops, the attention share of
    the matmul FLOPs, the bytes every op reads and writes, the bytes
    written to the host, and the live storages' bytes (a storage counts
    from the op that first writes it until its finalizer runs)."""

    def __init__(self, inputs):
        super().__init__()
        self.codes = _attention_codes()
        self.elementwise_flops = 0
        self.attention_flops = 0
        self.bytes = 0
        self.host_bytes = 0
        self.live = 0
        self.peak = 0
        self._live: Dict[int, int] = {}
        self._lock = threading.Lock()
        self._pending: list = []  # attention matmul outputs whose node to mark
        self._closed = False
        for t in _tensors(inputs):
            self._track(t)
        self.argument_bytes = self.live

    def _track(self, t: torch.Tensor) -> None:
        s = t.untyped_storage()
        key = s._cdata
        with self._lock:
            if key in self._live:
                return
            self._live[key] = s.nbytes()
            self.live += s.nbytes()
            self.peak = max(self.peak, self.live)
        weakref.finalize(s, self._free, key)

    def _free(self, key: int) -> None:
        with self._lock:
            if not self._closed:
                self.live -= self._live.pop(key, 0)

    def close(self) -> None:
        with self._lock:
            self._closed = True

    def _in_attention(self) -> bool:
        """An attention entry point is on this thread's Python stack, or,
        in the backward (no Python frames of the forward), the autograd
        node now running is an attention matmul's.  Under a checkpoint's
        frames forward code runs, a recompute too, and the stack alone
        decides: the node that triggered a recompute says nothing of the
        ops recomputed."""
        f, recompute = sys._getframe(2), False
        while f is not None:
            if f.f_code in self.codes:
                return True
            recompute = recompute or f.f_code.co_filename == _CHECKPOINT_FILE
            f = f.f_back
        if recompute:
            return False
        node = torch._C._current_autograd_node()
        return node is not None and bool(node.metadata.get(_ATTENTION))

    def _mark_pending(self) -> None:
        # an attention matmul's node exists once autograd has wrapped its
        # output, i.e. by the next op: mark it, so its backward counts too
        for ref in self._pending:
            out = ref()
            if out is not None and out.grad_fn is not None:
                out.grad_fn.metadata[_ATTENTION] = True
        self._pending = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._pending:
            self._mark_pending()
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if func.is_view:
            return out
        ins = {id(t): t for t in _tensors((args, kwargs))}
        packet = func.overloadpacket
        if packet in flop_registry:
            if self._in_attention():
                self.attention_flops += flop_registry[packet](*args, **kwargs, out_val=out)
                self._pending.extend(weakref.ref(t) for t in outs)
        elif packet not in _EMPTY:
            self.elementwise_flops += sum(t.numel() for t in outs
                                          if t.is_floating_point())
        if packet not in _EMPTY:
            self.bytes += sum(_nbytes(t) for t in ins.values()) + sum(map(_nbytes, outs))
        for t in outs:
            if t.device.type != "meta":
                self.host_bytes += _nbytes(t)
            self._track(t)
        return out


def measure(step, args) -> Dict[str, Any]:
    """Run ``step(*args)`` once under the counters; ``args`` are meta
    tensors (trees of them).  Returns the integer counts of the whole step
    and its outputs."""
    counter = _Counter(args)
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as flops, counter:
        out = step(*args)
    counter.close()
    matmul = int(flops.get_total_flops())
    return {"matmul_flops": matmul, "elementwise_flops": int(counter.elementwise_flops),
            "flops": matmul + int(counter.elementwise_flops),
            "attention_flops": int(counter.attention_flops), "bytes": int(counter.bytes),
            "host_bytes": int(counter.host_bytes),
            "argument_bytes": int(counter.argument_bytes),
            "peak_live_bytes": int(counter.peak), "seconds": time.perf_counter() - t0,
            "outputs": out}


# ---------------------------------------------------------------------------
# Specs -> bytes per device
# ---------------------------------------------------------------------------


def _axes_of(entry) -> tuple:
    return () if entry is None else (entry if isinstance(entry, tuple) else (entry,))


def shard_count(spec: tuple, mesh) -> int:
    return math.prod(mesh.shape[a] for e in spec for a in _axes_of(e))


def _pairs(tensors, specs) -> list:
    """(tensor, spec) for every leaf of a tree and its spec tree."""
    if isinstance(tensors, torch.Tensor):
        return [(tensors, specs)]
    if isinstance(tensors, dict):
        return [p for k in tensors for p in _pairs(tensors[k], specs[k])]
    return [p for t, s in zip(tensors, specs) for p in _pairs(t, s)]


def bytes_per_device(tensors, specs, mesh) -> int:
    return int(sum(_nbytes(t) // shard_count(s, mesh) for t, s in _pairs(tensors, specs)))


def _in_node(axes: tuple, mesh) -> bool:
    """Whether a group over ``axes`` stays inside one node: the mesh lays
    the cards out row-major, so only the innermost axes are contiguous."""
    names = list(mesh.shape)
    inner = names[len(names) - len(axes):]
    return sorted(axes, key=names.index) == inner and \
        math.prod(mesh.shape[a] for a in axes) <= CARDS_PER_NODE


def collective_bytes(kind: str, params, p_specs, mesh, *, n_micro: int,
                     remat: bool) -> Dict[str, Any]:
    """Per-device bytes of the parameter all-gathers and gradient
    reduce-scatters under ``COLLECTIVE_MODEL``."""
    gathers = n_micro * (2 if remat else 1) if kind == "train" else 1
    scatters = 1 if kind == "train" else 0
    by_link = {"nvlink": 0, "infiniband": 0}
    gather_b = scatter_b = 0
    for t, spec in _pairs(params, p_specs):
        f = shard_count(spec, mesh)
        if f == 1:
            continue
        moved = _nbytes(t) * (f - 1) // f
        link = "nvlink" if _in_node(tuple(a for e in spec for a in _axes_of(e)), mesh) \
            else "infiniband"
        gather_b += gathers * moved
        scatter_b += scatters * moved
        by_link[link] += (gathers + scatters) * moved
    return {"all_gather": gather_b, "reduce_scatter": scatter_b, "by_link": by_link,
            "seconds": by_link["nvlink"] / NVLINK_BW + by_link["infiniband"] / IB_BW}


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------


def _step_for(kind, cfg, run_cfg):
    return {"train": make_train_step, "prefill": make_prefill_step,
            "decode": make_decode_step}[kind](cfg, run_cfg)


def cell_config(arch: str, shape_name: str, overrides=None, smoke: bool = False):
    """(cfg, shape, run_cfg) of a cell, as JAX's dry run builds them: the
    plain ops (``decode_impl="ref"``).  At smoke size the microbatch count
    is cut to the smoke batch, which the published counts exceed."""
    cfg = get_config(arch, smoke=smoke).with_overrides(decode_impl="ref")
    if overrides:
        cfg = cfg.with_overrides(**overrides)
    shape = (SMOKE_SHAPES if smoke else SHAPES)[shape_name]
    run_cfg = default_run_config(arch, shape_name)
    if smoke:
        run_cfg = dataclasses.replace(
            run_cfg, num_microbatches=min(run_cfg.num_microbatches, shape.global_batch))
    return cfg, shape, run_cfg


def count_step(cfg, run_cfg, kind: str, args) -> Dict[str, Any]:
    """The step's counts (``measure``), with ``model_flops`` and
    ``model_matmul_flops`` from the same step without remat."""
    got = measure(_step_for(kind, cfg, run_cfg), args)
    if kind == "train" and run_cfg.remat != "none":
        bare = measure(_step_for(kind, cfg, dataclasses.replace(run_cfg, remat="none")),
                       args)
        got["model_flops"], got["model_matmul_flops"] = bare["flops"], bare["matmul_flops"]
    else:
        got["model_flops"], got["model_matmul_flops"] = got["flops"], got["matmul_flops"]
    return got


@functools.lru_cache(maxsize=4)
def _cell_counts(arch: str, shape_name: str, overrides: tuple,
                 smoke: bool) -> Dict[str, Any]:
    """A cell's counts, which no mesh changes (the step runs at the global
    shapes): one meta run serves both meshes."""
    cfg, shape, run_cfg = cell_config(arch, shape_name, dict(overrides), smoke)
    kind, args, _, _ = input_specs(cfg, shape, run_cfg, make_production_mesh())
    return count_step(cfg, run_cfg, kind, args)


def run_cell(arch: str, shape_name: str, mesh_kind: str, overrides=None,
             smoke: bool = False) -> dict:
    cfg, shape, run_cfg = cell_config(arch, shape_name, overrides, smoke)
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    n = math.prod(mesh.shape.values())
    kind, args, in_specs, out_specs = input_specs(cfg, shape, run_cfg, mesh)
    got = dict(_cell_counts(arch, shape_name, tuple(sorted((overrides or {}).items())),
                            smoke))
    outputs = got.pop("outputs")

    arg_b = bytes_per_device(args, in_specs, mesh)
    out_b = bytes_per_device(outputs, out_specs, mesh)
    donate = {"train": (0,), "prefill": (), "decode": (2,)}[kind]
    donated_b = sum(bytes_per_device(args[i], in_specs[i], mesh) for i in donate)
    peak_dev = arg_b + (got["peak_live_bytes"] - got["argument_bytes"]) // n
    params = args[0]["params"] if kind == "train" else args[0]
    p_specs = in_specs[0]["params"] if kind == "train" else in_specs[0]
    coll = collective_bytes(kind, params, p_specs, mesh,
                            n_micro=run_cfg.num_microbatches,
                            remat=kind == "train" and run_cfg.remat != "none")
    per = {k: got[k] / n for k in ("flops", "matmul_flops", "elementwise_flops",
                                   "attention_flops", "model_flops", "bytes")}
    peak = PEAK_FLOPS_BF16 if cfg.compute_dtype == torch.bfloat16 else PEAK_FLOPS_FP32
    roofline = {
        "compute_s": per["matmul_flops"] / peak + per["elementwise_flops"] / PEAK_FLOPS_FP32,
        "memory_s": per["bytes"] / HBM_BW,
        "collective_s": coll["seconds"],
    }
    roofline["dominant"] = max(roofline, key=lambda k: roofline[k])
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind, "kind": kind,
        "smoke": smoke, "n_chips": n, "ok": True, "run_s": got["seconds"],
        "batch": shape.global_batch, "seq": shape.seq_len,
        "num_microbatches": run_cfg.num_microbatches, "remat": run_cfg.remat,
        "compute_dtype": str(cfg.compute_dtype), "param_dtype": str(cfg.param_dtype),
        "hardware": HARDWARE, "flop_rule": FLOP_RULE,
        **per,
        "global": {k: got[k] for k in ("flops", "matmul_flops", "elementwise_flops",
                                       "attention_flops", "model_flops",
                                       "model_matmul_flops", "bytes", "argument_bytes",
                                       "peak_live_bytes", "host_bytes")},
        "bytes_model": BYTES_MODEL,
        "memory": {
            "argument_bytes": arg_b, "output_bytes": out_b, "donated_bytes": donated_b,
            "peak_live_bytes_estimate": got["peak_live_bytes"],
            "peak_live_bytes_per_device_estimate": peak_dev,
            "model": MEMORY_MODEL,
            "fits_80gb": bool(peak_dev <= HBM_PER_CARD),
        },
        "collective_bytes_per_device": coll["all_gather"] + coll["reduce_scatter"],
        "collectives": {k: coll[k] for k in ("all_gather", "reduce_scatter", "by_link")},
        "collective_model": COLLECTIVE_MODEL,
        "roofline": roofline, "compute_model": COMPUTE_MODEL,
    }


def cell_filename(arch, shape_name, mesh_kind):
    return f"{arch}__{shape_name}__{mesh_kind}.json"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke configs and shapes (CPU-sized)")
    ap.add_argument("--subprocess-per-cell", action="store_true",
                    help="isolate each cell in a child process (RSS containment)")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--override", default=None,
                    help="JSON dict of ModelConfig overrides (perf experiments)")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = [(a, s, m) for a in ARCHS for s in SHAPES for m in meshes
                 if shape_applicable(a, s)]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch/--shape required unless --all")
        cells = [(args.arch, args.shape, m) for m in meshes]

    failures = 0
    for arch, shape_name, mesh_kind in cells:
        path = os.path.join(args.out, cell_filename(arch, shape_name, mesh_kind))
        if args.skip_existing and os.path.exists(path):
            print(f"skip {path}")
            continue
        if args.subprocess_per_cell:
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                   "--shape", shape_name, "--mesh", mesh_kind, "--out", args.out]
            if args.smoke:
                cmd.append("--smoke")
            if args.override:
                cmd += ["--override", args.override]
            r = subprocess.run(cmd, capture_output=True, text=True)
            if r.returncode != 0:
                failures += 1
                print(f"FAIL (subprocess) {arch} {shape_name} {mesh_kind}")
                print(r.stdout[-2000:], r.stderr[-2000:])
            else:
                print(r.stdout.strip().splitlines()[-1] if r.stdout.strip() else "ok")
            continue
        t0 = time.time()
        try:
            overrides = json.loads(args.override) if args.override else None
            res = run_cell(arch, shape_name, mesh_kind, overrides, smoke=args.smoke)
        except Exception as e:  # noqa: BLE001 — record the failure, keep going
            res = {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "ok": False,
                   "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-4000:]}
            failures += 1
        with open(path, "w") as f:
            json.dump(res, f, indent=1)
        status = "OK " if res.get("ok") else "FAIL"
        dom = res.get("roofline", {}).get("dominant", "-")
        print(f"{status} {arch:22s} {shape_name:12s} {mesh_kind:6s} "
              f"t={time.time() - t0:6.1f}s dominant={dom}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
