"""The traffic generator: one open-loop schedule from a mix file, a rate
and a seed.

The seed draws the whole schedule, in blocks of ``mix["block"]``
consecutive requests.  Every block holds the same work in another order:
its inter-arrival gaps are the mid-quantiles of an exponential
distribution (a Poisson process's gaps), scaled so that a block spans
``block / rate`` seconds, and its prompt and output lengths one draw from
each of ``block`` equal-probability strata of their distributions.  The
seed orders each block's gaps and lengths and places each length inside
its stratum, and draws the token ids.  So two seeds send different
requests at different times, and every stretch of a few seconds of
either carries about the same prompt and output tokens: a window's work
does not hang on where the few longest requests fall.  The random calls
come in a fixed order: for each block the permutation of its gaps, the
prompt lengths' places in their strata and their permutation, the same
for the output lengths; then every prompt's token ids in one draw.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import numpy as np


@dataclasses.dataclass
class Arrival:
    t: float              # seconds after the window opens (negative: the ramp)
    prompt: np.ndarray    # int32 token ids
    max_new: int


def lengths(spec: Dict, u: np.ndarray) -> np.ndarray:
    """Integer lengths at the probabilities ``u`` of ``spec``
    ({"dist": "log_uniform" | "uniform", "min", "max"})."""
    lo, hi = float(spec["min"]), float(spec["max"])
    if spec["dist"] == "log_uniform":
        x = np.exp(np.log(lo) + u * (np.log(hi) - np.log(lo)))
    elif spec["dist"] == "uniform":
        x = lo + u * (hi - lo)
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return np.clip(np.rint(x), lo, hi).astype(np.int64)


def block_gaps(k: int, rate: float) -> np.ndarray:
    """The ``k`` mid-quantiles of an exponential distribution, scaled so
    that they sum to ``k / rate`` seconds."""
    g = -np.log1p(-(np.arange(k) + 0.5) / k)
    return g * (k / rate) / g.sum()


def schedule(mix: Dict, rate: float, seconds: float, seed: int, vocab: int) -> List[Arrival]:
    """Arrivals from ``-mix["ramp_s"]`` to ``seconds + mix["wait_after_s"]``
    at ``rate`` requests a second."""
    if mix.get("arrivals") != "poisson":
        raise ValueError(f"unknown arrival process {mix.get('arrivals')!r}")
    ramp, after = float(mix["ramp_s"]), float(mix["wait_after_s"])
    k = int(mix["block"])
    nb = int(math.ceil(rate * (ramp + seconds + after) / k))
    rng = np.random.default_rng(seed)
    base = block_gaps(k, rate)
    strata = np.arange(k)
    gaps, prompt_lens, out_lens = [], [], []
    for _ in range(nb):
        gaps.append(base[rng.permutation(k)])
        for spec, dst in ((mix["prompt_tokens"], prompt_lens), (mix["output_tokens"], out_lens)):
            one = lengths(spec, (strata + rng.random(k)) / k)
            dst.append(one[rng.permutation(k)])
    gaps, prompt_lens, out_lens = map(np.concatenate, (gaps, prompt_lens, out_lens))
    ids = rng.integers(0, vocab, int(prompt_lens.sum()), dtype=np.int64).astype(np.int32)
    times = np.cumsum(gaps) - gaps[0] - ramp
    ends = np.cumsum(prompt_lens)
    return [Arrival(float(t), ids[e - p:e], int(o))
            for t, p, e, o in zip(times, prompt_lens, ends, out_lens)]
