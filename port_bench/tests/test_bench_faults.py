"""A run on the CPU with the harness's look for a card skipped: sound, it
is correct; with the timed path broken underneath, ``correct`` comes out
false, once for each fault the cell can have."""
import torch

from port_bench.harness import main
from port_bench.tests import faults
from port_bench.tests.smoke import q18_options, smoke_options


def _fp32(o):
    o.model = (o.model[0].with_overrides(compute_dtype=torch.float32), o.model[1])
    return o


def test_serve_sound_run_is_correct():
    r = main.run(_fp32(smoke_options("phi3-mini-3.8b", limit=1e-3)))
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["e2e"]) == {"output_tokens_per_s", "ttft_p95_ms", "itl_p95_ms", "setup_s"}


def test_serve_token_altered_is_not_correct():
    r = main.run(_fp32(smoke_options("phi3-mini-3.8b", limit=1e-3, fault=faults.alter_tokens)))
    assert not r["correct"], r["checks"]
    assert r["checks"]["logit_gap_max"]["value"] > r["checks"]["logit_gap_max"]["limit"]


def test_arctic_as_the_port_wires_it_is_not_correct():
    """The port's Arctic layer departs from the published one (the experts
    read the post-attention stream): a sound run of it is not correct,
    which is why it has no cell."""
    r = main.run(_fp32(smoke_options("arctic-480b", limit=1e-3)))
    assert not r["correct"] and r["failed"] == 0, r["checks"]


def test_q18_sound_run_is_correct():
    r = main.run(q18_options())
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["e2e"]["rows_per_s"] > 0


def test_q18_exchange_left_out_is_not_correct():
    r = main.run(q18_options(fault_spec="port_bench.tests.faults:skip_exchange"))
    assert not r["correct"], r["checks"]


def test_q18_answer_altered_is_not_correct():
    r = main.run(q18_options(fault_spec="port_bench.tests.faults:alter_answer"))
    assert not r["correct"], r["checks"]
    assert r["checks"]["orderkey_sum_diff"]["value"] == 1.0
