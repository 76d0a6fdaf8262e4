"""CLI: ``python -m repro_torch.analysis [--baseline analysis-baseline-torch.json]``
(mirror of ``python -m repro.analysis``).

Runs the lock-discipline, host-sync (``jit``), kernel-contract,
broad-except, picklable-task and timeout passes over ``src/repro_torch``
and diffs the findings against the checked-in baseline.  Exit status 0 =
clean (no finding outside the baseline), 1 = dirty.  Stale baseline keys
(fixed findings still listed) are reported but do not fail the run:
prune them with ``--write-baseline``.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path
from typing import Dict, List

from repro_torch.analysis import (excepts, host_sync, kernel_contracts, locks, pickles,
                                  timeouts)
from repro_torch.analysis.findings import (
    Finding,
    diff_against_baseline,
    load_baseline,
    write_baseline,
)

REPO_ROOT = Path(__file__).resolve().parents[3]
SRC_ROOT = REPO_ROOT / "src" / "repro_torch"

# classes named in the lock-discipline contract live in these files
LOCK_FILES = [
    SRC_ROOT / "core" / "agent.py",
    SRC_ROOT / "core" / "exec" / "transport.py",
    SRC_ROOT / "core" / "exec" / "worker.py",
    SRC_ROOT / "core" / "pipeline.py",
    SRC_ROOT / "core" / "pilot.py",
    SRC_ROOT / "core" / "session.py",
    SRC_ROOT / "core" / "task.py",
    SRC_ROOT / "serve" / "engine.py",
    SRC_ROOT / "serve" / "router.py",
]

# blocking-call timeout discipline applies to the runtime files (the
# lock-discipline set plus the wire/persistence layers)
TIMEOUT_FILES = LOCK_FILES + [
    SRC_ROOT / "core" / "exec" / "protocol.py",
    SRC_ROOT / "core" / "transport.py",
    SRC_ROOT / "checkpoint" / "store.py",
]

ALL_PASSES = ("locks", "jit", "kernels", "excepts", "pickles", "timeouts")


def run_passes(names) -> List[Finding]:
    findings: List[Finding] = []
    for name in names:
        t0 = time.perf_counter()
        if name == "locks":
            got = locks.run([p for p in LOCK_FILES if p.exists()], REPO_ROOT)
        elif name == "jit":
            got = host_sync.run(host_sync.src_modules(SRC_ROOT), REPO_ROOT)
        elif name == "kernels":
            got = kernel_contracts.run()
        elif name == "excepts":
            got = excepts.run(sorted(SRC_ROOT.rglob("*.py")), REPO_ROOT)
        elif name == "pickles":
            got = pickles.run(sorted(SRC_ROOT.rglob("*.py")), REPO_ROOT)
        elif name == "timeouts":
            got = timeouts.run([p for p in TIMEOUT_FILES if p.exists()], REPO_ROOT)
        else:
            raise SystemExit(f"unknown pass {name!r}; known: {ALL_PASSES}")
        dt = time.perf_counter() - t0
        print(f"pass {name:8s}: {len(got)} finding(s) in {dt:.2f}s")
        findings.extend(got)
    return findings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis")
    ap.add_argument("--baseline", type=Path,
                    default=REPO_ROOT / "analysis-baseline-torch.json")
    ap.add_argument("--write-baseline", action="store_true",
                    help="accept current findings as the new baseline")
    ap.add_argument("--passes", default=",".join(ALL_PASSES),
                    help=f"comma-separated subset of {ALL_PASSES}")
    args = ap.parse_args(argv)

    names = [n.strip() for n in args.passes.split(",") if n.strip()]
    findings = run_passes(names)

    if args.write_baseline:
        write_baseline(args.baseline, findings)
        print(f"wrote {len({f.key() for f in findings})} key(s) to "
              f"{args.baseline}")
        return 0

    baseline = load_baseline(args.baseline)
    new, stale = diff_against_baseline(findings, baseline)
    for f in new:
        print(f"NEW {f.render()}")
    for key in sorted(stale):
        print(f"stale baseline entry (fixed? prune with --write-baseline): "
              f"{key}")
    if new:
        print(f"DIRTY: {len(new)} new finding(s) vs baseline "
              f"{args.baseline.name}")
        return 1
    print(f"clean: {len(findings)} finding(s), all baselined "
          f"({len(baseline)} baseline key(s))")
    return 0


if __name__ == "__main__":
    sys.exit(main())
