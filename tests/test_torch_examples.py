"""The PyTorch port's examples (``examples/*_torch.py``, the mirrors of
JAX's), each run on the CPU in a subprocess with ``--device cpu``, at a
smaller size where the example has one: each must exit 0 and print its
``OK`` line, and import neither JAX nor the JAX package."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

# example -> (extra arguments, the OK line it prints)
EXAMPLES = {
    "quickstart_torch": ((), "quickstart_torch OK"),
    "train_lm_torch": (("--steps", "20"), "train_lm_torch OK"),
    "forecasting_pipeline_torch": (("--models", "NLinear,GRU", "--steps", "10"),
                                   "forecasting pipeline_torch OK"),
    "hydrology_pipeline_torch": (("--steps", "20"), "hydrology pipeline_torch OK"),
    "fault_tolerant_train_torch": ((), "fault_tolerant_train_torch OK"),
    "serve_lm_torch": (("--batch", "2", "--prompt-len", "8", "--gen", "4"),
                       "serve_lm_torch OK"),
}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_the_cpu(name, tmp_path):
    path = ROOT / "examples" / f"{name}.py"
    tree = ast.parse(path.read_text())
    mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    mods += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    assert not [m for m in mods if m.split(".")[0] in ("jax", "repro")], mods
    args, ok = EXAMPLES[name]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               TMPDIR=str(tmp_path))
    r = subprocess.run([sys.executable, str(path), "--device", "cpu", *args],
                       capture_output=True, text=True, timeout=300, env=env, cwd=tmp_path)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert ok in r.stdout
