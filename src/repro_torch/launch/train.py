"""Training entry point of the port (mirror of ``repro.launch.train``).

``make_corpus`` builds the synthetic corpus the JAX package trains on,
value for value.  ``run`` is the paper's ``preprocess >> train >>
postprocess`` stage graph under a ``Session``, a ``PilotManager`` and a
dataframe ``Table``; those come with the data-engineering and runtime
slices, so until then it raises.  The train loop itself is
``repro_torch.train.step.make_train_step`` over
``repro_torch.train.state.init_train_state``.
"""
from __future__ import annotations

import numpy as np


def make_corpus(vocab: int, n_tokens: int, seed: int = 0) -> np.ndarray:
    """Synthetic Zipf-ish corpus with local structure (learnable bigrams)."""
    rng = np.random.default_rng(seed)
    base = rng.zipf(1.3, size=n_tokens).clip(max=vocab - 1)
    # inject deterministic bigram structure so loss can actually drop
    base[1::2] = (base[::2][: len(base[1::2])] * 7 + 3) % vocab
    return base.astype(np.int32)


def run(args) -> dict:
    raise NotImplementedError(
        "the training entry point runs as a Session stage graph "
        "(preprocess >> train >> postprocess) over a Table and a "
        "PilotManager: it waits for the data-engineering and runtime "
        "slices (ROADMAP.md queue 1, items 10 and 11)")
