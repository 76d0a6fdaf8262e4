"""Port parity: configs and spec trees of ``repro_torch`` against
``repro``, and the lint that keeps the port free of jax and repro."""
import pytest

torch = pytest.importorskip("torch")

import ast  # noqa: E402
import dataclasses  # noqa: E402
from pathlib import Path  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jcfg  # noqa: E402
import repro_torch.configs as tcfg  # noqa: E402
from repro.common.params import is_param as j_is_param  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.common.params import tree_leaves  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.train.state import model_specs  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
ARCHS = sorted(jcfg.ARCHS)


def _dense_gqa(arch):
    cfg = jcfg.get_config(arch)
    head, unit, _, tail = jcfg.block_pattern(cfg)
    return not cfg.is_encoder_decoder and set((*head, *unit, *tail)) <= {("attn", "mlp")}


# decoder-only archs whose every layer is (attn, mlp): the port's slice
DENSE_GQA = [a for a in ARCHS if _dense_gqa(a)]


def _norm(v):
    """Comparable form of a config value: dtypes by name."""
    if isinstance(v, torch.dtype):
        return str(v).removeprefix("torch.")
    try:
        return np.dtype(v).name if not isinstance(v, (str, bool, int, float, tuple)) else v
    except TypeError:
        return v


def test_registry_matches():
    assert tcfg.ARCHS == jcfg.ARCHS


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_match(arch, smoke):
    j = jcfg.get_config(arch, smoke=smoke)
    t = tcfg.get_config(arch, smoke=smoke)
    jf = {f.name: _norm(getattr(j, f.name)) for f in dataclasses.fields(j)}
    tf = {f.name: _norm(getattr(t, f.name)) for f in dataclasses.fields(t)}
    assert tf == jf
    assert t.padded_vocab == j.padded_vocab
    assert t.padded_gqa() == j.padded_gqa()
    assert t.qk_head_dim == j.qk_head_dim
    assert tcfg.block_pattern(t) == jcfg.block_pattern(j)
    assert dataclasses.asdict(tcfg.RunConfig()).keys() == \
        dataclasses.asdict(jcfg.RunConfig()).keys()


def _shapes(tree, is_leaf):
    if isinstance(tree, dict):
        return {k: _shapes(v, is_leaf) for k, v in tree.items()}
    assert is_leaf(tree)
    return (tuple(tree.shape), _norm(tree.dtype), tree.init)


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", DENSE_GQA)
def test_spec_trees_match(arch, smoke):
    j = jcfg.get_config(arch, smoke=smoke)
    t = tcfg.get_config(arch, smoke=smoke)
    assert _shapes(tlm.lm_specs(t), lambda x: True) == \
        _shapes(jlm.lm_specs(j), j_is_param)
    assert _shapes(tlm.lm_paged_cache_specs(t, 12, 16), lambda x: True) == \
        _shapes(jlm.lm_paged_cache_specs(j, 12, 16), j_is_param)


def test_dense_gqa_subset_is_the_expected_one():
    assert DENSE_GQA == ["phi3-medium-14b", "phi3-mini-3.8b", "qwen2-vl-72b",
                         "tinyllama-1.1b"]


@pytest.mark.parametrize("arch", sorted(set(ARCHS) - set(DENSE_GQA)))
def test_unported_archs_raise(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model_specs(tcfg.get_config(arch, smoke=True))


def test_param_count_matches():
    cfg = tcfg.get_config("tinyllama-1.1b")
    n = sum(int(np.prod(p.shape)) for p in tree_leaves(tlm.lm_specs(cfg)))
    jn = sum(int(np.prod(p.shape)) for p in
             jax.tree.leaves(jlm.lm_specs(jcfg.get_config("tinyllama-1.1b")),
                             is_leaf=j_is_param))
    assert n == jn


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_no_jax_and_no_repro():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    bad = [(str(f.relative_to(REPO)), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro", "flax")]
    assert not bad, bad
