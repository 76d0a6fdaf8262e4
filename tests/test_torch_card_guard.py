"""A kernel runs on its tensors' card, whichever card the calling thread has
current: every ctypes launch of ``src/repro_torch/kernels/`` goes through
``build.launch``, which makes the tensors' card current around the call,
and no CUDA source raises a kernel's dynamic shared-memory cap once per
process (the attribute belongs to each card's context).  On the CPU the
helper's two branches run against stand-ins for torch's device calls;
``chip_smoke.py --cards`` runs the kernels on card 1 of four H100s."""
import ast
import contextlib
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402

KERNELS = Path(build.__file__).resolve().parent
ENTRIES = set(build.SIGNATURES) | set(build.EXTRA_ENTRIES)
# the sources whose tensor-core kernels take more than 48 KB of dynamic
# shared memory, raised per card through raise_smem_cap (common.cuh)
TC_SOURCES = ("decode_attention", "decode_attention_paged", "flash_attention",
              "prefill_attention", "prefill_attention_paged")


def _wrapper_modules():
    return sorted(p for p in KERNELS.glob("*.py") if p.name not in ("build.py", "__init__.py"))


def _launches(tree):
    """The entry names of every ``build.launch("name", ...)`` call."""
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "launch" and isinstance(node.func.value, ast.Name) \
                and node.func.value.id == "build":
            first = node.args[0] if node.args else None
            assert isinstance(first, ast.Constant), ast.dump(node)[:200]
            out.append(first.value)
    return out


def test_every_kernel_launch_goes_through_the_card_guard():
    """No wrapper gets hold of a library's entry point (it loads no library)
    or takes a stream itself: each launch is ``build.launch(entry,
    tensor, ...)``, and every entry point has one."""
    launched = []
    for path in _wrapper_modules():
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            name = node.attr if isinstance(node, ast.Attribute) else \
                node.id if isinstance(node, ast.Name) else None
            assert name not in ("load", "_load", "entry_point", "CDLL", "cdll",
                                "current_stream", "cuda_stream",
                                "_cuda_getCurrentRawStream"), \
                f"{path.name}:{node.lineno} uses {name} outside build.launch"
        launched += _launches(tree)
    assert set(launched) == ENTRIES, launched
    # in build.py the entry function is called in launch alone
    tree = ast.parse((KERNELS / "build.py").read_text())
    callers = {fn.name for fn in ast.walk(tree) if isinstance(fn, ast.FunctionDef)
               for node in ast.walk(fn) if isinstance(node, ast.Call)
               and isinstance(node.func, ast.Name) and node.func.id == "entry_point"}
    assert callers == {"launch"}


class _Recorder:
    """Stand-ins for the entry point, torch's current-card calls and
    ``torch.cuda.device``."""

    def __init__(self, current):
        self.current, self.calls, self.entered = current, [], []

    def entry(self, *args):
        self.calls.append((args, self.current))
        return 0

    @contextlib.contextmanager
    def device(self, card):
        before, self.current = self.current, card
        self.entered.append(card)
        try:
            yield
        finally:
            self.current = before


class _OnCard:
    def __init__(self, card):
        self.card = card

    def get_device(self):
        return self.card


@pytest.mark.parametrize("current,card", [(0, 0), (1, 1), (0, 1), (2, 3)])
def test_launch_makes_the_tensors_card_current_only_when_it_is_not(monkeypatch, current,
                                                                     card):
    rec = _Recorder(current)
    monkeypatch.setattr(build, "entry_point", lambda name: rec.entry)
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: rec.current, raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda c: 1000 + c, raising=False)
    monkeypatch.setattr(torch.cuda, "device", rec.device)
    build.launch("rmsnorm", _OnCard(card), 7, 8)
    # the stream is the tensors' card's, appended; the call ran with that
    # card current; a context manager only where it was not current; the
    # thread's current card is left as it was
    assert rec.calls == [((7, 8, 1000 + card), card)]
    assert rec.entered == ([] if current == card else [card])
    assert rec.current == current


def test_launch_raises_on_a_cuda_error(monkeypatch):
    monkeypatch.setattr(build, "entry_point", lambda name: lambda *a: 400)
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: 0, raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda c: 0, raising=False)
    monkeypatch.setattr(build, "load", lambda lib: type(
        "Lib", (), {"kernel_error_string": staticmethod(lambda e: b"invalid resource handle")}))
    with pytest.raises(RuntimeError, match="paged_scatter kernel launch failed: CUDA error "
                                           "400 \\(invalid resource handle\\)"):
        build.launch("paged_scatter", _OnCard(0))


def _strip_comments(src: str) -> str:
    return re.sub(r"//[^\n]*", "", src)


def test_no_cu_source_keeps_a_once_per_process_attribute_flag():
    """The shared-memory cap is raised once per card: no source keeps a
    scalar static flag; every static flag is an array of kMaxCards handed
    to raise_smem_cap, which indexes it by cudaGetDevice; the only
    cudaFuncSetAttribute outside raise_smem_cap runs on every launch."""
    csrc = KERNELS / "csrc"
    common = _strip_comments((csrc / "common.cuh").read_text())
    body = common[common.index("inline cudaError_t raise_smem_cap"):]
    body = body[:body.index("\n}\n")]
    assert body.index("cudaGetDevice(&card)") < body.index("raised[card]") \
        < body.index("cudaFuncSetAttribute(")
    for path in sorted(csrc.glob("*.cu*")):
        src = _strip_comments(path.read_text())
        assert not re.search(r"static\s+bool\s+\w+\s*(=|;)", src), path.name
        flags = re.findall(r"static\s+bool\s+(\w+)\s*\[([^\]]*)\]", src)
        assert all(size == "kMaxCards" for _, size in flags), (path.name, flags)
        for name, _ in flags:
            assert re.search(rf"raise_smem_cap\(\s*{name}\s*,", src), (path.name, name)
        if path.stem in TC_SOURCES:
            assert len(flags) == 1, path.name
        # a cudaFuncSetAttribute outside raise_smem_cap sits in no branch
        # that a static guards
        if path.name != "common.cuh":
            for m in re.finditer(r"cudaFuncSetAttribute\(", src):
                guard = src[max(0, m.start() - 300):m.start()]
                assert "static" not in guard, (path.name, guard)
