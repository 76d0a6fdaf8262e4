"""Per-slot sampling state for the ServeEngine (mirror of
``repro.serve.sampling``, greedy path).

Greedy decoding (the default) is the argmax the step factories already
return.  Seeded temperature / top-k sampling is not ported: bitwise-equal
streams need JAX's threefry2x32 with its ``split`` and ``gumbel`` bit
conversions (ROADMAP.md queue 1, item 3), so the engine refuses
``temperature > 0`` at ``submit``.  The per-slot keys are still built and
checkpointed, so the engine state keeps the JAX engine's layout.
"""
from __future__ import annotations

import numpy as np


def make_slot_key(seed: int) -> np.ndarray:
    """Per-request threefry key (uint32[2]) from a request seed, the same
    (hi, lo) packing ``jax.random.PRNGKey`` produces."""
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                    np.uint32)
