"""One run of one cell: arguments, the cell's files by name, the device
checks, the runner, the metrics of the run's kind, the result line."""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import Any, Callable, Dict, Optional

from port_bench.harness import common


@dataclasses.dataclass
class Options:
    workload: str
    seed: int
    seconds: float
    trace: bool
    t_start: float
    cell: Dict
    config: Dict
    traffic: Dict
    chips: int
    device: str = "cuda"
    model: Any = None                 # a test's own (port config, sizes)
    fault: Optional[Callable] = None  # a test's fault planted in the engine
    fault_spec: Optional[str] = None  # "module:function" a test plants in every rank
    control: bool = False             # also read the lower-precision control


def parse(argv):
    ap = argparse.ArgumentParser(prog="port_bench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def load(workload: str):
    """The BENCHMARK.json entries, the cell file, the configuration and
    the traffic mix of ``workload``."""
    bench = common.benchmark()
    wl = {w["name"]: w for w in bench["workloads"]}.get(workload)
    if wl is None:
        raise common.BenchError(f"no workload {workload!r} in BENCHMARK.json")
    cfg_entry = {c["name"]: c for c in bench["configs"]}[wl["config"]]
    cell = common.load_json(common.BENCH / "cells" / f"{workload}.json")
    config = common.load_json(common.ROOT / cfg_entry["file"])
    mix = common.load_json(common.BENCH / "traffic" / f"{wl['traffic']}.json")
    return bench, wl, cell, config, mix


def metric_names(bench: Dict, workload: str, kind: str):
    return [m["name"] for m in bench[kind]
            if "workloads" not in m or workload in m["workloads"]]


def run(opts: Options) -> Dict:
    """The cell's runner (``runners/<cell runner>.py``) on ``opts``."""
    import importlib

    return importlib.import_module(f"port_bench.runners.{opts.cell['runner']}").run(opts)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    os.environ.update(common.cache_env())
    try:
        bench, wl, cell, config, mix = load(args.workload)
        import torch

        chips = int(wl["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise common.BenchError(
                f"{args.workload} needs {chips} CUDA device(s); found "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        torch.set_num_threads(4)
        common.import_program()
        opts = Options(args.workload, args.seed, args.seconds, bool(args.trace), t_start,
                       cell, config, mix, chips)
        res = run(opts)
        bad = common.forbidden_modules()
        if bad:
            raise common.BenchError(f"the process holds forbidden modules: {bad}")
        kind = "per_layer" if args.trace else "end_to_end"
        names = metric_names(bench, args.workload, kind)
        units = {m["name"]: m["unit"] for m in bench[kind]}
        if args.trace:
            metrics = common.read_metrics(names, res["ctx"], units)
        else:
            missing = [n for n in names if n not in res["e2e"]]
            if missing:
                raise common.BenchError(f"the runner gave no {missing}")
            metrics = {n: {"value": float(res["e2e"][n]), "unit": units[n]} for n in names}
        device = common.device_line(torch, chips, res["peak"])
        if args.trace:
            device["busy_s"] = res["busy_s"]
            device["window_s"] = res["window_s"]
        line = {"correct": res["correct"], "attempted": res["attempted"],
                "failed": res["failed"], "metrics": metrics, "device": device}
        if args.trace and res.get("breakdown"):
            line["breakdown"] = res["breakdown"]
        print(f"info {res.get('info', {})}", file=sys.stderr)
        common.emit(line, res["checks"])
        return 0
    except common.BenchError as e:
        print(f"port_bench: {e}", file=sys.stderr)
        return 3
