"""The port's dry run on the meta device (``repro_torch.launch.dryrun``), on
the CPU.

Every (arch x shape) cell that ``shape_applicable`` admits runs at smoke
size through ``run_cell`` on meta tensors: no op writes a tensor on the
CPU (a dispatch mode of this test watches every op), and every count and
roofline term is finite.  tinyllama's smoke train, prefill and decode
steps: ``matmul_flops`` and ``attention_flops`` equal the formulas below,
written from the config's widths, exactly; ``flops`` (matmuls plus one
FLOP per output element of every other op) lies in a band of JAX's
trip-count ``hlo_analysis`` of the same step compiled on the CPU, which
adds one FLOP per element of every materializing instruction after XLA's
fusion.  The ratios measured (jax 0.9.0, torch 2.13): train 0.893,
prefill 0.936, decode 0.751; the bands are those +-0.05.  Full width runs
only for tinyllama's decode_32k (the meta runs of xlstm's and arctic's
train_4k take minutes)."""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch.configs import ARCHS, SHAPES, SMOKE_SHAPES, get_config, shape_applicable  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CELLS = [(a, s) for a in ARCHS for s in SHAPES if shape_applicable(a, s)]
# port flops / JAX hlo_analysis flops, measured +-0.05
HLO_BAND = {"train_4k": (0.843, 0.943), "prefill_32k": (0.886, 0.986),
            "decode_32k": (0.701, 0.801)}


class HostWrites(TorchDispatchMode):
    """Bytes of every tensor an op writes on the CPU."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor) and t.device.type == "cpu":
                self.bytes += t.numel() * t.element_size()
        return out


def _finite(r) -> bool:
    nums = [r["roofline"][k] for k in ("compute_s", "memory_s", "collective_s")]
    nums += [r[k] for k in ("flops", "matmul_flops", "elementwise_flops",
                            "attention_flops", "model_flops", "bytes")]
    nums += [r["memory"][k] for k in ("argument_bytes", "output_bytes",
                                      "peak_live_bytes_per_device_estimate")]
    return all(math.isfinite(x) and x >= 0 for x in nums)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_every_smoke_cell_runs_on_meta_without_host_memory(arch, shape):
    watch = HostWrites()
    with watch:
        r = dryrun.run_cell(arch, shape, "single", smoke=True)
    assert watch.bytes == 0 and r["global"]["host_bytes"] == 0
    assert r["ok"] and r["kind"] == SMOKE_SHAPES[shape].kind and _finite(r)
    assert r["roofline"]["dominant"] in ("compute_s", "memory_s", "collective_s")
    g = r["global"]
    assert g["flops"] == g["matmul_flops"] + g["elementwise_flops"] > 0
    assert 0 <= g["attention_flops"] <= g["matmul_flops"]
    assert g["model_flops"] <= g["flops"]
    assert g["peak_live_bytes"] >= g["argument_bytes"] > 0
    assert r["memory"]["argument_bytes"] <= g["argument_bytes"]


def tinyllama_flops(cfg, kind: str, B: int, S: int):
    """(matmul FLOPs, attention FLOPs, matmul FLOPs without remat) of
    tinyllama's step on the plain path: per token and layer the Q/K/V and
    O projections and the SwiGLU MLP's three matmuls, the LM head per
    token whose logits are computed
    (every token in training, the last in a prefill), and the attention
    products over the full S x S square (or the S cached positions of a
    decode).  Training is the forward, twice it in the backward, and the
    remat recompute of every layer but its last matmul (the MLP's down
    projection: the checkpoint stops recomputing once the saved tensors
    are back)."""
    d, ff, V, L, D = cfg.d_model, cfg.d_ff, cfg.padded_vocab, cfg.num_layers, cfg.head_dim
    H, KV = cfg.padded_gqa()
    layer = 2 * d * (H * D + 2 * KV * D) + 2 * H * D * d + 3 * 2 * d * ff
    down = 2 * ff * d
    head = 2 * d * V
    if kind == "decode":
        attn = 4 * B * H * S * D
        flops = L * (B * layer + attn) + B * head
        return flops, L * attn, flops
    attn = 4 * B * H * S * S * D
    if kind == "prefill":
        flops = L * (B * S * layer + attn) + B * head
        return flops, L * attn, flops
    fwd = L * (B * S * layer + attn) + B * S * head
    recompute = L * (B * S * (layer - down) + attn)
    return 3 * fwd + recompute, 4 * L * attn, 3 * fwd


def _jax_hlo_flops(shape: str) -> float:
    import jax

    from repro.configs import SMOKE_SHAPES as JSMOKE
    from repro.configs import default_run_config, get_config as jget_config
    from repro.distributed import hlo_analysis
    from repro.launch.mesh import make_mesh
    from repro.launch.specs import input_specs
    from repro.train.step import make_decode_step, make_prefill_step, make_train_step

    cfg = jget_config("tinyllama-1.1b", smoke=True).with_overrides(decode_impl="ref")
    run_cfg = default_run_config("tinyllama-1.1b", shape)
    kind, args, _, _ = input_specs(cfg, JSMOKE[shape], run_cfg,
                                   make_mesh((1, 1), ("data", "model")))
    step = {"train": make_train_step, "prefill": make_prefill_step,
            "decode": make_decode_step}[kind](cfg, run_cfg)
    return hlo_analysis.analyze(jax.jit(step).lower(*args).compile().as_text())[
        "flops_per_device"]


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_tinyllama_flops_formula_and_hlo_band(shape):
    r = dryrun.run_cell("tinyllama-1.1b", shape, "single", smoke=True)
    cfg = get_config("tinyllama-1.1b", smoke=True)
    sh = SMOKE_SHAPES[shape]
    matmul, attn, bare = tinyllama_flops(cfg, sh.kind, sh.global_batch, sh.seq_len)
    g = r["global"]
    assert g["matmul_flops"] == matmul
    assert g["attention_flops"] == attn
    assert g["model_matmul_flops"] == bare
    ratio = g["flops"] / _jax_hlo_flops(shape)
    lo, hi = HLO_BAND[shape]
    assert lo <= ratio <= hi, (shape, ratio)


def test_tinyllama_full_width_decode_on_both_meshes():
    single = dryrun.run_cell("tinyllama-1.1b", "decode_32k", "single")
    multi = dryrun.run_cell("tinyllama-1.1b", "decode_32k", "multi")
    cfg = get_config("tinyllama-1.1b")
    sh = SHAPES["decode_32k"]
    matmul, attn, _ = tinyllama_flops(cfg, "decode", sh.global_batch, sh.seq_len)
    for r, n in ((single, 256), (multi, 512)):
        assert r["n_chips"] == n and _finite(r)
        assert r["global"]["matmul_flops"] == matmul
        assert r["global"]["attention_flops"] == attn
        assert r["matmul_flops"] == matmul / n
        # the cache [L, B, S, KV, D] x 2 in bf16, split over the batch by
        # ("pod", "data") and over the positions by "model"
        cache = 2 * cfg.num_layers * sh.global_batch * sh.seq_len * cfg.num_kv_heads \
            * cfg.head_dim * 2
        assert r["memory"]["donated_bytes"] == cache // n
        assert r["memory"]["fits_80gb"]
        assert r["roofline"]["dominant"] == "collective_s"
    assert single["global"] == multi["global"]  # one meta run serves both meshes


def test_measure_counts_a_known_function():
    """x [1000] fp32 -> (x * 2).sum(): 1000 + 1 FLOPs outside matmuls; the
    live peak is x, the product and the sum, 4000 + 4000 + 4 bytes."""
    x = torch.empty(1000, device="meta")
    got = dryrun.measure(lambda t: (t * 2).sum(), (x,))
    assert got["matmul_flops"] == 0 and got["elementwise_flops"] == 1001
    assert got["argument_bytes"] == 4000 and got["peak_live_bytes"] == 8004
    assert got["bytes"] == 4000 + 4000 + 4000 + 4
    w = torch.empty(64, 32, device="meta", requires_grad=True)
    got = dryrun.measure(lambda a, b: a @ b, (torch.empty(8, 64, device="meta"), w))
    assert got["matmul_flops"] == 2 * 8 * 64 * 32 and got["attention_flops"] == 0


def test_collective_links_follow_the_node_layout():
    mesh = type("M", (), {"shape": {"data": 4, "model": 8}})()
    assert dryrun._in_node(("model",), mesh)
    assert not dryrun._in_node(("data",), mesh)
    assert not dryrun._in_node(("data", "model"), mesh)
    big = dryrun.make_production_mesh()
    assert not dryrun._in_node(("model",), big)  # 16 cards: two nodes
    assert dryrun.shard_count((("pod", "data"), None, "model"),
                              dryrun.make_production_mesh(multi_pod=True)) == 512


def test_cli_writes_one_file_per_mesh(tmp_path):
    rc = dryrun.main(["--arch", "tinyllama-1.1b", "--shape", "decode_32k", "--mesh",
                      "both", "--smoke", "--out", str(tmp_path)])
    assert rc == 0
    for mesh in ("single", "multi"):
        r = json.loads((tmp_path / dryrun.cell_filename(
            "tinyllama-1.1b", "decode_32k", mesh)).read_text())
        assert r["ok"] and r["mesh"] == mesh and r["hardware"]["peak_flops_bf16"] == 989e12
    sub = tmp_path / "sub"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "tinyllama-1.1b",
         "--shape", "prefill_32k", "--smoke", "--subprocess-per-cell", "--out", str(sub)],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stdout + out.stderr
    assert json.loads((sub / dryrun.cell_filename(
        "tinyllama-1.1b", "prefill_32k", "single")).read_text())["ok"]
