"""Seeded host syncs for the port's ``jit`` pass (parsed, never executed;
the twin of ``tests/fixtures_analysis/jit_fixture.py``).

Expected findings, asserted exactly in ``tests/test_torch_analysis.py``:
in ``leaky_step`` (the closure ``make_leaky_step`` returns) a wall-clock
read, a branch on a tensor, ``float()`` of a tensor, ``.item()``,
boolean-mask indexing, ``torch.nonzero``, ``np.asarray``, ``.to("cpu")``,
``repeat_interleave`` with tensor repeats, ``torch.cuda.synchronize()``
and a ``while`` on a tensor; in ``_to_host``, which it calls with a
tensor, ``.tolist()``.

``clean_step`` exercises the exemptions: ``is None``, shapes, devices,
keyword-only (static) parameters, int repeats, metadata methods, a
closure's static config, and a read marked ``# sync-ok: <reason>``.
"""
import time

import numpy as np
import torch


def _to_host(v):
    return v.tolist()  # SEEDED: .tolist() of a tensor


def make_leaky_step(scale):
    def leaky_step(x, lengths):
        t0 = time.perf_counter()  # SEEDED: wall clock in a step
        y = x.sum() * scale
        if y > 0:  # SEEDED: Python branch on a tensor
            y = y + 1.0
        peek = float(y)  # SEEDED: host cast of a tensor
        n = lengths.max().item()  # SEEDED: .item()
        rows = x[lengths > 0]  # SEEDED: boolean-mask indexing
        idx = torch.nonzero(lengths)  # SEEDED: data-shaped output
        host = np.asarray(x)  # SEEDED: numpy of a tensor
        back = y.to("cpu")  # SEEDED: copy to the host
        reps = x.repeat_interleave(lengths, dim=0)  # SEEDED: tensor repeats
        torch.cuda.synchronize()  # SEEDED: device sync
        while lengths.sum() < 3:  # SEEDED: while on a tensor
            lengths = lengths + 1
        listed = _to_host(y)
        return y, t0, peek, n, rows, idx, host, back, reps, listed

    return leaky_step


def clean_step(x, mask=None, *, eps=1e-5, window=0):
    if mask is not None:  # static: identity test
        x = torch.where(mask, x, 0.0)
    if x.ndim > 1 and x.device.type == "cuda":  # static: metadata
        x = x.reshape(-1)
    if window:  # static: a keyword-only parameter
        x = x[:window]
    x = x.repeat_interleave(2, dim=0)  # static: int repeats
    n = int(x.numel())  # static: a metadata method
    ok = all(t.data_ptr() % 16 == 0 for t in (x,))  # static: pointers
    peek = float(x.sum())  # sync-ok: a seeded read, marked with its reason
    return x * eps, n, ok, peek
