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
from repro_torch.kernels import build  # noqa: E402
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
# the MLA and MoE archs, served since queue 1 item 3
MLA_MOE = ["arctic-480b", "minicpm3-4b", "moonshot-v1-16b-a3b"]
SERVED = sorted(DENSE_GQA + MLA_MOE)


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
@pytest.mark.parametrize("arch", SERVED)
def test_spec_trees_match(arch, smoke):
    j = jcfg.get_config(arch, smoke=smoke)
    t = tcfg.get_config(arch, smoke=smoke)
    assert _shapes(tlm.lm_specs(t), lambda x: True) == \
        _shapes(jlm.lm_specs(j), j_is_param)
    assert _shapes(tlm.lm_paged_cache_specs(t, 12, 16), lambda x: True) == \
        _shapes(jlm.lm_paged_cache_specs(j, 12, 16), j_is_param)
    assert _shapes(tlm.lm_cache_specs(t, 3, 20), lambda x: True) == \
        _shapes(jlm.lm_cache_specs(j, 3, 20), j_is_param)


def test_dense_gqa_subset_is_the_expected_one():
    assert DENSE_GQA == ["phi3-medium-14b", "phi3-mini-3.8b", "qwen2-vl-72b",
                         "tinyllama-1.1b"]


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", SERVED)
def test_served_configs_fit_the_attention_kernels(arch, smoke):
    """Every config the port serves, after ``padded_gqa``: each attention
    kernel its serving path reaches is instantiated for the head dim the
    path gives it, at a group the decode kernels take (G <= 32), so on the
    card its attention never reaches a kernel that refuses it.  A GQA
    stack on token inputs reaches both decodes and both prefills at its
    head dim; an MLA stack only the contiguous decode, at nope + rope with
    G 1 (24 for minicpm3's smoke width, 96 at full width); qwen2-vl,
    which the engine refuses (embedding inputs, M-RoPE), only the
    contiguous decode of its decode step."""
    cfg = tcfg.get_config(arch, smoke=smoke)
    shapes = tlm.serving_attention_shapes(cfg)
    if cfg.attention == "mla":
        H, _ = cfg.padded_gqa()
        assert shapes == {"decode_attention": (H, H, cfg.nope_head_dim + cfg.rope_head_dim)}
    elif arch == "qwen2-vl-72b":
        assert shapes == {"decode_attention": (4, 2, 32) if smoke else (64, 8, 128)}
    else:
        assert len(shapes) == 4
    for kernel, (H, KV, D) in shapes.items():
        assert D in build.head_dims(kernel), (arch, kernel, D)
        build.check_head_dim(kernel, D)
        assert H % KV == 0 and H // KV <= 32, (arch, kernel, H, KV)


# the recurrent architectures: decoded token by token over the contiguous
# cache, trained, never served by the engine (as in JAX)
RECURRENT = ["recurrentgemma-9b", "xlstm-125m"]
# the encoder-decoder and the embedding-input M-RoPE stack: trained,
# prefilled without a cache and decoded by their decode steps alone, never
# served by the engine (as in JAX)
DECODE_STEP_ONLY = ["qwen2-vl-72b", "whisper-medium"]


def test_every_arch_is_ported():
    assert sorted(set(SERVED) | set(RECURRENT) | set(DECODE_STEP_ONLY)) == ARCHS


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_decode_paths_fit_the_attention_kernels(arch, smoke):
    """recurrentgemma's local layers decode through the contiguous decode
    over their ring, at (H, KV, D) = (16, 1, 256) at full width (4, 1, 16
    at smoke width), groups the kernel takes (16 and 4); xlstm has no
    attention, so its decode reaches no kernel."""
    cfg = tcfg.get_config(arch, smoke=smoke)
    shapes = tlm.serving_attention_shapes(cfg)
    if arch == "xlstm-125m":
        assert shapes == {}
        return
    assert shapes == {"decode_attention": (16, 1, 256) if not smoke else (4, 1, 16)}
    for kernel, (H, KV, D) in shapes.items():
        build.check_head_dim(kernel, D)
        assert H % KV == 0 and H // KV <= 32


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", DECODE_STEP_ONLY)
def test_decode_step_paths_fit_the_attention_kernels(arch, smoke):
    """whisper's decode step runs the contiguous decode over its self and
    its cross cache at (16, 16, 64) (4, 4, 16 at smoke width), qwen2-vl's
    at (64, 8, 128) (4, 2, 32): kernel 2 alone, at head dims and groups
    it takes; the model specs build."""
    cfg = tcfg.get_config(arch, smoke=smoke)
    want = {("whisper-medium", False): (16, 16, 64), ("whisper-medium", True): (4, 4, 16),
            ("qwen2-vl-72b", False): (64, 8, 128), ("qwen2-vl-72b", True): (4, 2, 32)}
    shapes = tlm.serving_attention_shapes(cfg)
    assert shapes == {"decode_attention": want[arch, smoke]}
    H, KV, D = shapes["decode_attention"]
    build.check_head_dim("decode_attention", D)
    assert H % KV == 0 and H // KV <= 32
    assert tree_leaves(model_specs(cfg))


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


def _landed_refusals():
    """Each piece the port once deferred with a refusal naming its
    ROADMAP.md queue 1 item, and what its call says now that it landed."""
    import torch

    from repro_torch.core.communicator import build_communicator

    return {
        # item 6: a gang over worker processes; one process still refuses
        "communicator_across_cards": ('transport="subprocess"', lambda: build_communicator(
            [torch.device("cuda", 0), torch.device("cuda", 1)])),
    }


@pytest.mark.parametrize("case", sorted(_landed_refusals()))
def test_every_deferred_refusal_names_its_item(case):
    """No refusal in the port points to a ROADMAP.md queue 1 item any
    more: every deferred piece landed, and a call the port still refuses
    names its remedy."""
    remedy, call = _landed_refusals()[case]
    with pytest.raises(ValueError, match=remedy):
        call()
    stale = [f"{f.relative_to(REPO)}:{i}" for f in sorted((REPO / "src" / "repro_torch").rglob("*.py"))
             for i, line in enumerate(f.read_text().splitlines(), 1)
             if "ROADMAP.md queue 1, item" in line]
    assert not stale, stale
