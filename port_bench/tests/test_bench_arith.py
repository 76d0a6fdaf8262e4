"""The frozen byte and FLOP counts against hand counts, and the FLOP
formula against the port's dry run at one phi3-mini shape."""
import pytest
import torch

from port_bench.arith import flops, kernels
from port_bench.runners.serve import dims
from port_bench.harness import common

PHI3 = dims(common.load_json(common.BENCH / "configs" / "phi3-mini-3.8b.json"))


def test_decode_paged_by_hand():
    # two rows of 5 and 17 positions, H 4, KV 2, D 8, bf16, pages of 16
    f, b = kernels.decode_paged(4, 2, 8, [5, 17])
    assert f == 4 * 4 * 8 * (5 + 17)
    kv = 2 * (5 + 17) * 2 * 8 * 2          # K and V, every position read once
    qo = 2 * (2 * 4 * 8 * 2)               # each row's query read, output written
    assert b == kv + qo + 4 * (1 + 2)      # block-table entries of 1 and 2 pages


def test_prefill_paged_by_hand():
    # one row: 3 tokens at offset 4 attend 5, 6 and 7 positions
    f, b = kernels.prefill_paged(2, 1, 4, [(4, 3)])
    assert f == 4 * 2 * 4 * (5 + 6 + 7)
    assert b == 2 * 7 * 1 * 4 * 2 + 2 * 3 * 2 * 4 * 2 + 4 * 1


def test_bound_takes_the_larger():
    assert kernels.bound_s(989e12, 0) == pytest.approx(1.0)
    assert kernels.bound_s(0, 3.35e12) == pytest.approx(1.0)


def test_phi3_layer_flops_by_hand():
    d, ff = 3072, 8192
    assert flops.layer_flops_per_token(PHI3) == 2 * d * 3 * d + 2 * d * d + 6 * d * ff
    # the published count: about 3.82 B parameters, 2 FLOPs each a token
    n = 32 * flops.layer_flops_per_token(PHI3) / 2 + 2 * 32064 * d
    assert 3.7e9 < n < 3.9e9


def test_moe_counts_top_k_experts_only():
    m = dict(PHI3, num_experts=128, top_k=2, dense_ff=4864, d_ff=4864)
    d = m["d_model"]
    base = 2 * d * 3 * d + 2 * d * d
    assert flops.layer_flops_per_token(m) == base + 2 * d * 128 + 2 * 6 * d * 4864 + 6 * d * 4864


def test_phi3_flops_match_the_dry_run():
    """The port's dry run counts the matmuls of a no-cache forward of 256
    tokens on the meta device; without the attention einsums (which the
    plain path runs over the full square) and with the head counted on
    the last position only, it must equal the formula."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import measure
    from repro_torch.train.state import model_specs
    from repro_torch.common.params import abstract_params
    from repro_torch.train.step import make_prefill_step

    cfg = get_config("phi3-mini-3.8b").with_overrides(decode_impl="ref", q_chunk=256,
                                                      kv_chunk=256)
    S = 256
    params = abstract_params(model_specs(cfg))
    batch = {"tokens": torch.zeros((1, S), dtype=torch.int64, device="meta")}
    got = measure(make_prefill_step(cfg), (params, batch))
    H, D, L = 32, 96, 32
    square_attention = L * 4 * H * D * S * S
    want = S * L * flops.layer_flops_per_token(PHI3) + 2 * 3072 * 32064
    assert got["matmul_flops"] - square_attention == want
