"""``engine.prefill_pad_share`` on hand-made counters, on a program
without the slab counter, and on a CPU run of the serving runner."""
from port_bench.harness import common, main
from port_bench.tests.smoke import smoke_options


def _read(ctx):
    return common.import_file(common.BENCH / "metrics" / "engine.prefill_pad_share.py",
                              "port_bench_test_pad_share").read(ctx)


def test_pad_share_is_the_slab_positions_without_a_prompt_token():
    st = {"prefill_tokens": 480, "prefill_slab_positions": 32 * 512, "prefill_chunks": 1}
    assert _read({"kind": "serve", "stats": st}) == 100.0 * (1 - 480 / 16384)
    full = {"prefill_tokens": 64, "prefill_slab_positions": 64}
    assert _read({"stats": full}) == 0.0


def test_pad_share_gives_nothing_where_nothing_was_counted():
    assert _read({"kind": "serve", "stats": None}) is None
    assert _read({"kind": "dataframe", "ranks": []}) is None
    # the parent's engine: no slab counter
    assert _read({"stats": {"prefill_tokens": 480, "prefill_chunks": 1}}) is None
    assert _read({"stats": {"prefill_tokens": 0, "prefill_slab_positions": 0}}) is None


def test_pad_share_of_a_cpu_serving_run():
    r = main.run(smoke_options("phi3-mini-3.8b", seconds=1.5))
    st = r["ctx"]["stats"]
    assert st["prefill_slab_positions"] % r["ctx"]["max_slots"] == 0
    share = _read(r["ctx"])
    assert 0.0 < share < 100.0
    assert share == 100.0 * (1 - st["prefill_tokens"] / st["prefill_slab_positions"])
