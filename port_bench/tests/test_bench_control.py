"""The lower-precision control, put in the program's place, comes out as
not correct through the harness's own checks.

On the CPU at smoke size: the float8 control of a served model and the
bfloat16 control of Q18.  On the card at each cell's own size (``-m
cuda``; ``python -m pytest -m cuda port_bench/tests/test_bench_control.py``
from the repository's root): the program's own readings pass the cell's
limit and the control's fail it, on one seed a cell (the cell's limits
were set from a dozen seeds and three controls, ``PERF.md``)."""
import time

import pytest
import torch

from port_bench.harness import common, main
from port_bench.tests.smoke import q18_options, smoke_options

SEED = 2**31 + 4099


def test_served_control_is_not_correct_cpu():
    o = smoke_options("phi3-mini-3.8b")
    o.control = True
    r = main.run(o)
    served, ctrl = r["info"]["served_gaps"], r["info"]["control_gaps"]
    assert not r["correct"], r["checks"]
    assert r["checks"]["logit_gap_max"]["value"] == ctrl["max"]
    assert served["max"] <= o.cell["limits"]["logit_gap_max"] < ctrl["max"]
    assert ctrl["max"] > 3 * served["max"]


def test_q18_control_is_not_correct_cpu():
    o = q18_options(seed=11)
    o.config = dict(o.config, orders_rows=4 * 16384, groups_cap_per_rank=32768)
    o.control = True
    r = main.run(o)
    assert not r["correct"], r["checks"]
    assert all(v <= (o.cell["limits"]["price_sum_rel_err"] if k == "price_sum_rel_err" else 0)
               for k, v in r["info"]["program"].items())


def _cell_control(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs the card: the control runs at the cell's own size")
    bench, wl, cell, config, mix = main.load(workload)
    if torch.cuda.device_count() < int(wl["chips"]):
        pytest.skip(f"{workload} needs {wl['chips']} cards")
    common.import_program()
    o = main.Options(workload, SEED, 30.0, False, time.time(), cell, config, mix,
                     int(wl["chips"]), control=True)
    return cell, main.run(o)


@pytest.mark.cuda
def test_served_control_is_not_correct():
    cell, r = _cell_control("phi3-mini.chat")
    assert not r["correct"], r["checks"]
    stat, limit = next(iter(cell["limits"].items()))
    key = stat.replace("logit_gap_", "")
    assert r["info"]["served_gaps"][key] <= limit < r["info"]["control_gaps"][key]


@pytest.mark.cuda
def test_q18_control_is_not_correct():
    cell, r = _cell_control("tpch-q18.sf10.4card")
    assert not r["correct"], r["checks"]
    assert r["info"]["program"]["price_sum_rel_err"] <= cell["limits"]["price_sum_rel_err"]
