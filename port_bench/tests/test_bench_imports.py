"""The benchmark's process never holds JAX or the JAX package, and its
reference imports nothing of the program."""
import ast
import subprocess
import sys
import types

from port_bench.harness import common

MODULES = sorted(
    ".".join(p.relative_to(common.ROOT).with_suffix("").parts)
    for p in common.BENCH.rglob("*.py")
    if "tests" not in p.parts and "." not in p.stem and p.stem != "run")


def test_no_module_holds_jax_or_the_jax_package():
    """Import every module of the benchmark (and the program parts they
    import) in a fresh process; compare whole top-level names."""
    code = ("import sys\n"
            f"sys.path[:0] = [{str(common.ROOT)!r}, {str(common.ROOT / 'src')!r}]\n"
            "import importlib\n"
            f"for m in {MODULES!r}:\n    importlib.import_module(m)\n"
            "from port_bench.harness import common\n"
            "for p in (common.BENCH / 'metrics').glob('*.py'):\n"
            "    common.import_file(p, 'metric_' + p.stem.replace('.', '_'))\n"
            "import repro_torch.serve, repro_torch.dataframe.ops_dist\n"
            "print(common.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    for k in [k for k in sys.modules if k.split(".")[0] in common.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, k)
    monkeypatch.setitem(sys.modules, "repro_torch_bench_probe", types.ModuleType("x"))
    assert common.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    monkeypatch.setitem(sys.modules, "repro.serve", types.ModuleType("repro.serve"))
    assert common.forbidden_modules() == ["jax", "repro"]


def test_reference_imports_nothing_of_the_program():
    for p in (common.BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(p.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in ("repro_torch", "repro", "jax"), (p, n)
