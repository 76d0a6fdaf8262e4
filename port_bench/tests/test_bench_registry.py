"""A later change adds a cell, a traffic mix or a per-layer metric by
adding files and BENCHMARK.json entries, editing no file that is there:
shown in a copy of the benchmark."""
import json
import shutil
import subprocess
import sys

from port_bench.harness import common

PROBE = r'''
import json, sys
sys.path[:0] = [sys.argv[1], sys.argv[2]]
from port_bench.harness import common, main, traffic
bench, wl, cell, config, mix = main.load("phi3-mini.burst")
names = main.metric_names(bench, "phi3-mini.burst", "per_layer")
units = {m["name"]: m["unit"] for m in bench["per_layer"]}
got = common.read_metrics(names, {"probe": 41.5}, units)
arr = traffic.schedule(mix, cell["rate_per_s"], 5.0, 3, 100)
print(json.dumps({"root": str(common.ROOT), "cell": cell["rate_per_s"], "mix": mix["why"],
                  "names": names, "got": got, "n": len(arr)}))
'''


def test_new_cell_traffic_and_metric_files_are_taken_up(tmp_path):
    shutil.copy(common.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(common.BENCH, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "port_bench").rglob("*") if p.is_file()}
    b = tmp_path / "port_bench"
    (b / "cells" / "phi3-mini.burst.json").write_text(json.dumps(
        dict(common.load_json(b / "cells" / "phi3-mini.chat.json"), rate_per_s=0.75)))
    (b / "traffic" / "burst.json").write_text(json.dumps(
        dict(common.load_json(b / "traffic" / "chat.json"), why="a probe mix")))
    (b / "metrics" / "probe.metric.py").write_text(
        "def read(ctx):\n    return ctx.get('probe')\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "phi3-mini.burst", "config": "phi3-mini-3.8b",
                               "traffic": "burst", "chips": 1, "why": "probe"})
    bench["per_layer"].append({"name": "probe.metric", "unit": "ms", "better": "lower",
                               "source": "host_clock", "layer": "probe",
                               "moves": "itl_p95_ms", "workloads": ["phi3-mini.burst"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    out = subprocess.run([sys.executable, "-c", PROBE, str(tmp_path), str(common.ROOT / "src")],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["root"] == str(tmp_path)
    assert got["cell"] == 0.75 and got["mix"] == "a probe mix" and got["n"] > 0
    assert got["names"] == ["probe.metric"]
    assert got["got"] == {"probe.metric": {"value": 41.5, "unit": "ms"}}
    for rel, data in before.items():
        assert (tmp_path / rel).read_bytes() == data
