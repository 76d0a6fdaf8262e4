"""The traffic generator: one seed, one schedule; another seed, another
schedule; lengths inside the mix's bounds; every block of requests the
same work in another order."""
import numpy as np

from port_bench.harness import common
from port_bench.harness.traffic import block_gaps, lengths, schedule

CHAT = common.load_json(common.BENCH / "traffic" / "chat.json")
SEED = 2**31 + 977


def _key(arrivals):
    return [(a.t, a.max_new, a.prompt.tobytes()) for a in arrivals]


def test_one_seed_one_schedule():
    a = schedule(CHAT, 1.3, 45.0, SEED, 32064)
    b = schedule(CHAT, 1.3, 45.0, SEED, 32064)
    assert _key(a) == _key(b)


def test_another_seed_another_schedule():
    """The seed draws the arrival times and the lengths, not the token ids
    alone."""
    a = schedule(CHAT, 1.3, 45.0, SEED, 32064)
    b = schedule(CHAT, 1.3, 45.0, SEED + 12345, 32064)
    assert [x.t for x in a] != [x.t for x in b]
    assert [x.prompt.shape[0] for x in a] != [x.prompt.shape[0] for x in b]
    assert [x.max_new for x in a] != [x.max_new for x in b]


def test_lengths_inside_the_mix():
    arr = schedule(CHAT, 2.0, 45.0, SEED, 32064)
    p = np.array([a.prompt.shape[0] for a in arr])
    o = np.array([a.max_new for a in arr])
    assert p.min() >= CHAT["prompt_tokens"]["min"] and p.max() <= CHAT["prompt_tokens"]["max"]
    assert o.min() >= CHAT["output_tokens"]["min"] and o.max() <= CHAT["output_tokens"]["max"]
    # every sequence fits 2047 positions: phi3-mini's published window sees all of it
    assert (p + o).max() <= 2047
    ids = np.concatenate([a.prompt for a in arr])
    assert ids.min() >= 0 and ids.max() < 32064
    t = np.array([a.t for a in arr])
    assert t[0] == -CHAT["ramp_s"] and np.all(np.diff(t) > 0)
    # whole blocks: the schedule ends within one block past the wait
    assert 45.0 + CHAT["wait_after_s"] - CHAT["block"] / 2.0 <= t[-1]
    assert t[-1] <= 45.0 + CHAT["wait_after_s"] + CHAT["block"] / 2.0


def test_medians_are_the_sources():
    """The chat mix's medians: 1020 prompt and 128 output tokens (the
    Azure conversation trace's 1020 and 129)."""
    arr = schedule(CHAT, 2.0, 45.0, SEED, 32064)
    assert abs(np.median([a.prompt.shape[0] for a in arr]) - 1020) < 40
    assert abs(np.median([a.max_new for a in arr]) - 128) < 12


def test_every_block_the_same_work():
    """Each block of requests spans the same seconds, and holds one prompt
    and one output length from each stratum, on every seed."""
    k = CHAT["block"]
    for seed in (SEED, SEED + 1, 3):
        arr = schedule(CHAT, 1.3, 45.0, seed, 32064)
        assert len(arr) % k == 0
        t = np.array([a.t for a in arr])
        span = t[k::k] - t[:-k:k]
        assert np.allclose(span, k / 1.3, atol=block_gaps(k, 1.3).max() + 1e-9)
        for b in range(len(arr) // k):
            blk = arr[b * k:(b + 1) * k]
            for spec, vals in ((CHAT["prompt_tokens"], [a.prompt.shape[0] for a in blk]),
                               (CHAT["output_tokens"], [a.max_new for a in blk])):
                edges = lengths(spec, np.arange(k + 1) / k)
                got = np.sort(vals)
                assert np.all(got >= edges[:-1]) and np.all(got <= edges[1:])


def test_block_gaps_keep_the_rate():
    g = block_gaps(8, 1.25)
    assert abs(g.sum() - 8 / 1.25) < 1e-12 and np.all(np.diff(g) > 0)


def test_log_uniform_lengths():
    u = (np.arange(4) + 0.5) / 4
    q = lengths({"dist": "log_uniform", "min": 32, "max": 512}, u)
    assert list(q) == list(np.rint(np.exp(np.log(32) + u * np.log(16))))
