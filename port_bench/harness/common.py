"""What every cell shares: finding files by name, the program's import
path, the device line, the result line and the checks it ends with."""
from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Sequence

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
# the top-level module names the benchmark's process must never hold
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class BenchError(RuntimeError):
    """A run that cannot give a result: exit non-zero, print none."""


def process_start_time() -> float:
    """When this process started, on ``time.time()``'s clock (from
    /proc: its start in clock ticks after boot, and the uptime)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


def cache_env() -> Dict[str, str]:
    """Build and kernel caches at fixed paths inside the checkout (the
    program's own CUDA libraries land in ``build/kernels`` there)."""
    base = ROOT / "build" / "port_bench_cache"
    return {"TRITON_CACHE_DIR": str(base / "triton"),
            "TORCH_EXTENSIONS_DIR": str(base / "torch_extensions"),
            "CUDA_CACHE_PATH": str(base / "nv"), "OMP_NUM_THREADS": "4"}


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict:
    return load_json(ROOT / "BENCHMARK.json")


def import_file(path: Path, name: str):
    """A module from a file whose name may hold dots (a metric's name)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise BenchError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def import_program():
    """Put the program's sources on the path and import its package; a
    checkout without them gives no result."""
    src = ROOT / "src"
    if not (src / "repro_torch" / "__init__.py").exists():
        raise BenchError(f"the program is not in this checkout ({src / 'repro_torch'})")
    if str(src) not in sys.path:
        sys.path.insert(0, str(src))
    import repro_torch  # noqa: F401


def forbidden_modules() -> List[str]:
    return sorted({n.split(".", 1)[0] for n in list(sys.modules)} & set(FORBIDDEN))


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile, linear between order statistics (numpy's
    default)."""
    v = sorted(values)
    if not v:
        return float("nan")
    k = (len(v) - 1) * q / 100.0
    lo = math.floor(k)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (k - lo)


def device_line(torch, count: int, peak: int) -> Dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(peak)}


def read_metrics(names: Sequence[str], ctx: Dict, units: Dict[str, str]) -> Dict:
    """Each per-layer metric from its reader ``metrics/<name>.py``
    (``read(ctx)``); a reader that finds nothing returns None and the
    metric is left out."""
    out = {}
    for name in names:
        mod = import_file(BENCH / "metrics" / f"{name}.py", f"port_bench_metric_{len(out)}")
        value = mod.read(ctx)
        if value is not None:
            out[name] = {"value": float(value), "unit": units[name]}
    return out


def emit(result: Dict, checks: Dict[str, Dict]) -> None:
    """The checks on standard error as its last lines, then the result
    line on standard output, the checks its last key."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    line = dict(result)
    line["checks"] = checks
    print(json.dumps(line), flush=True)
