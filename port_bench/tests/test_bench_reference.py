"""The port held to the benchmark's references at smoke sizes on the CPU
(float32, where the two differ only in the order of sums): the dense and
the MoE model through the paged engine's chunks and decode steps, and
Q18 by hand."""
import numpy as np
import pytest
import torch

from port_bench.runners.serve import Tracked, record_step
from port_bench.harness import weights
from port_bench.reference.lm import Ref, Seq, gaps
from port_bench.reference.q18 import query
from port_bench.tests.smoke import smoke_dims


def _engine_streams(arch, lens, seed=3, chunk=32, std=0.2, **over):
    from repro_torch.configs import get_config
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.request import Request
    from repro_torch.train.state import model_specs

    cfg = get_config(arch, smoke=True).with_overrides(compute_dtype=torch.float32, **over)
    W = weights.make(model_specs(cfg), seed, "cpu", torch.float32, std=std)
    eng = ServeEngine(cfg, params=W, device="cpu", max_slots=4, max_len=96, page_size=16,
                      prefill_chunk_tokens=chunk)
    rng = np.random.default_rng(seed)
    act = []
    for i, L in enumerate(lens):
        r = eng.submit(Request(rng.integers(0, cfg.vocab_size, L).astype(np.int32),
                               max_new_tokens=12))
        act.append(Tracked(i, r, 0.0, L))
    done = list(act)
    while eng.has_work():
        eng.step()
        record_step(eng, act, 0.0, 0.0)
        act = [t for t in act if not t.req.done()]
    return cfg, W, done


class ProgramWiring(Ref):
    """The reference with the experts on the post-attention stream, as
    ``repro_torch``'s ``moe_apply`` computes them: a witness that
    localises the program's departure, never the benchmark's reference."""

    def moe_reads(self, layer_in, post_attn):
        return post_attn


def _served_gaps(cfg, W, done, ref_cls=Ref):
    ref = ref_cls(W, smoke_dims(cfg))
    seqs = [Seq(list(map(int, t.req.prompt)) + t.req.tokens[:-1], t.prompt_len, t.chunks)
            for t in done]
    return [gaps(lg, t.req.tokens) for lg, t in zip(ref.served_logits(seqs), done)]


def test_dense_engine_matches_the_reference():
    cfg, W, done = _engine_streams("phi3-mini-3.8b", [50, 20, 33, 70])
    for g in _served_gaps(cfg, W, done):
        assert float(g.max()) < 1e-4


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_moe_engine_departs_from_the_published_layer(seed):
    """The port's Arctic layer routes and runs its experts on the
    post-attention stream; the published layer (``parallel_attn_mlp_res``)
    feeds them the layer's input.  Served tokens then lie whole logits
    below the reference's best, on every seed."""
    cfg, W, done = _engine_streams("arctic-480b", [50, 20, 33, 70], seed=seed,
                                   capacity_factor=1.0)
    assert max(float(g.max()) for g in _served_gaps(cfg, W, done)) > 0.1


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_moe_engine_matches_the_reference_but_for_the_experts_input(seed):
    """With the experts' input as the port wires it, the reference agrees
    with the engine through chunks of several widths, padded rows and
    capacity drops: the departure is that input alone."""
    cfg, W, done = _engine_streams("arctic-480b", [50, 20, 33, 70], seed=seed,
                                   capacity_factor=1.0)
    assert any(T > take for t in done for _, take, T in t.chunks)
    for g in _served_gaps(cfg, W, done, ProgramWiring):
        assert float(g.max()) < 1e-4


def test_moe_reference_needs_the_padding():
    """Without the chunks' padding in its routing groups the reference
    departs from the engine: the padding claims expert capacity."""
    cfg, W, done = _engine_streams("arctic-480b", [50, 20, 33, 70], capacity_factor=1.0)
    for t in done:
        t.chunks = [(off, take, take) for off, take, _ in t.chunks]
    assert max(float(g.max()) for g in _served_gaps(cfg, W, done, ProgramWiring)) > 1e-3


def test_q18_by_hand():
    cfg = {"having_quantity_over": 300}
    shards = [{"o_orderkey": np.array([1, 2, 3], np.int32),
               "o_totalprice": np.array([10.0, 20.0, 40.0], np.float32),
               "l_orderkey": np.array([1, 1, 2, 3, 3, 3, 3, 3, 3, 3], np.int32),
               "l_quantity": np.array([50, 50, 50, 49, 49, 49, 49, 49, 49, 49], np.float32)}]
    got = query(shards, cfg)
    assert got == {"o_totalprice": 40.0, "l_quantity": 343.0, "_count": 7.0, "o_orderkey": 3.0,
                   "orders": 1}
    low = query(shards, cfg, bf16=True)
    assert low["l_quantity"] != 343.0          # 343 needs 9 significant bits
