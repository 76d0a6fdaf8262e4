#!/usr/bin/env python3
"""Readings for setting a cell's rate and limits, many runs in one
process (set-up is paid once for the imports and the kernel build):

    python3 port_bench/calibrate.py --workload <cell> --seeds 11,12 \\
        [--rates 0.5,1.0] [--seconds 30] [--wait 20] [--control 1] [--out FILE]

Each (rate, seed) runs the cell's runner with that rate (the cell's own
by default) and a window of ``--seconds``; one JSON line a run gives the
end-to-end metrics, the checks, ``correct`` and the program's own
readings (``info``).  With ``--control 1`` the lower-precision control's
answer takes the program's place in the checks, so ``correct`` and the
checks are the control's and ``info`` keeps the program's.  The
benchmark's own runs never run the control."""
import argparse
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from port_bench.harness import common, main  # noqa: E402


def run(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--rates", default="")
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--wait", type=float, default=None)
    ap.add_argument("--ramp", type=float, default=None)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    os.environ.update(common.cache_env())
    bench, wl, cell, config, mix = main.load(args.workload)
    import torch

    common.import_program()
    if args.wait is not None:
        mix = dict(mix, wait_after_s=args.wait)
    if args.ramp is not None:
        mix = dict(mix, ramp_s=args.ramp)
    rates = [float(r) for r in args.rates.split(",") if r] or [cell.get("rate_per_s")]
    out = open(args.out, "a") if args.out else None
    for rate in rates:
        for seed in [int(s) for s in args.seeds.split(",")]:
            c = dict(cell, rate_per_s=rate) if rate is not None else cell
            opts = main.Options(args.workload, seed, args.seconds, False, time.time(), c,
                                config, mix, int(wl["chips"]), control=bool(args.control))
            t0 = time.time()
            res = main.run(opts)
            row = {"workload": args.workload, "rate": rate, "seed": seed,
                   "correct": res["correct"], "attempted": res["attempted"],
                   "failed": res["failed"], "e2e": res["e2e"], "checks": res["checks"],
                   "info": res.get("info"), "peak": res["peak"], "wall_s": time.time() - t0,
                   "stats": {k: v for k, v in (res["ctx"].get("stats") or {}).items()
                             if isinstance(v, (int, float))}}
            print(json.dumps(row), flush=True)
            if out:
                out.write(json.dumps(row) + "\n")
                out.flush()
            del res
            torch.cuda.empty_cache()


if __name__ == "__main__":
    run(sys.argv[1:])
