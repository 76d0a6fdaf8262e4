"""Small CPU stand-ins of the serving cells for the benchmark's tests:
the port's smoke configs, a tiny engine and a short chat mix."""
from __future__ import annotations

import time

from port_bench.harness import main


def smoke_dims(cfg, **moe):
    m = {"d_model": cfg.d_model, "num_heads": cfg.num_heads, "num_kv_heads": cfg.num_kv_heads,
         "head_dim": cfg.head_dim, "d_ff": cfg.d_ff, "num_layers": cfg.num_layers,
         "vocab_size": cfg.vocab_size, "rope_theta": cfg.rope_theta, "norm_eps": cfg.norm_eps}
    if cfg.num_experts:
        m.update(num_experts=cfg.num_experts, top_k=cfg.top_k,
                 capacity_factor=cfg.capacity_factor, min_capacity=4, dense_ff=cfg.dense_ff)
    return m


def smoke_options(arch: str, seed: int = 7, seconds: float = 2.0, limit: float = 0.25,
                  fault=None, rate: float = 6.0, **cfg_over):
    import torch
    from repro_torch.configs import get_config

    cfg = get_config(arch, smoke=True).with_overrides(
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16, **cfg_over)
    cell = {"runner": "serve", "rate_per_s": rate, "trace_s": 1.0,
            "engine": {"max_slots": 4, "max_len": 96, "page_size": 16,
                       "prefill_chunk_tokens": 32},
            "limits": {"logit_gap_max": limit}}
    mix = {"kind": "open_loop", "arrivals": "poisson", "block": 4,
           "prompt_tokens": {"dist": "log_uniform", "min": 8, "max": 60},
           "output_tokens": {"dist": "log_uniform", "min": 4, "max": 24},
           "temperature": 0.0, "ramp_s": 0.5, "wait_after_s": 20.0,
           "sample_served_tokens": 40, "sample_max_requests": 4}
    config = {"initializer_range": 0.2}
    return main.Options(f"{arch}.smoke", seed, seconds, False, time.time(), cell, config,
                        mix, 1, device="cpu", model=(cfg, smoke_dims(cfg)), fault=fault)


def q18_options(seed: int = 5, seconds: float = 1.0, fault_spec=None, trace=False):
    """TPC-H Q18's cell at a few thousand rows on 4 gloo ranks of the CPU."""
    from port_bench.harness import common

    cfg = dict(common.load_json(common.BENCH / "configs" / "tpch-q18.json"),
               orders_rows=4 * 2048, groups_cap_per_rank=4096)
    cell = {"runner": "q18", "trace_s": 0.5, "limits": {"price_sum_rel_err": 1e-5}}
    return main.Options("tpch-q18.smoke", seed, seconds, trace, time.time(), cell, cfg,
                        {"kind": "back_to_back"}, 4, device="cpu", fault_spec=fault_spec)
