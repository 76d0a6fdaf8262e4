"""Deep RC Data Bridge: the zero-copy data loader (mirror of
``repro.bridge.loader``).

Paper §2.4: the Cylon Global Table is handed to the DL framework without a
materializing copy; workers prefetch batches in parallel; pinned memory +
DMA overlap host->device transfers.

* ``ZeroCopyLoader``: the table's columns already live on the device.  A
  batch is a gather (``index_select``) on those tensors: no host round
  trip, no copy of the table.
* ``HostPrefetcher``: for host-resident sources, keeps ``depth`` transfers
  in flight: pinned host memory and ``non_blocking`` copies on a side
  stream for a CUDA target, the consumer's stream waiting on each batch's
  event.

Shuffling draws from a ``torch.Generator``, so its permutations (and
``window_batches``' starts) are not jax threefry's from the same seed
(ROADMAP.md queue 3); unshuffled batches equal JAX's.
"""
from __future__ import annotations

import collections
import threading
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from repro_torch.dataframe.table import Table
from repro_torch.launch.mesh import resolve_device


class ZeroCopyLoader:
    """Iterate (features, labels, mask) minibatches straight off a Table.
    Batches are gathers on the table's device tensors; an optional
    per-epoch on-device permutation provides shuffling."""

    def __init__(
        self,
        table: Table,
        feature_cols: Sequence[str],
        label_col: str,
        global_batch: int,
        *,
        shuffle: bool = True,
        seed: int = 0,
        drop_remainder: bool = True,
    ):
        self.table = table
        self.feature_cols = list(feature_cols)
        self.label_col = label_col
        self.global_batch = int(global_batch)
        self.shuffle = shuffle
        self.seed = seed
        n = table.num_rows
        self.steps_per_epoch = n // self.global_batch if drop_remainder else -(-n // self.global_batch)

    def _gather(self, perm: torch.Tensor, step: int):
        # a last partial batch starts early, as jax's dynamic_slice clamps it
        lo = max(min(step * self.global_batch,
                     self.table.num_rows - self.global_batch), 0)
        idx = perm[lo:lo + self.global_batch]
        cols = self.table.columns
        feats = torch.stack([cols[c].index_select(0, idx).float()
                             for c in self.feature_cols], dim=-1)
        labels = cols[self.label_col].index_select(0, idx)
        mask = self.table.valid.index_select(0, idx)
        return feats, labels, mask

    def epoch(self, epoch_idx: int = 0) -> Iterator:
        n = self.table.num_rows
        dev = self.table.valid.device
        if self.shuffle:
            gen = torch.Generator(device=dev).manual_seed(self.seed + epoch_idx)
            perm = torch.randperm(n, generator=gen, device=dev)
        else:
            perm = torch.arange(n, device=dev)
        for step in range(self.steps_per_epoch):
            yield self._gather(perm, step)

    def __iter__(self):
        return self.epoch(0)


def _map(fn, item):
    """``fn`` over the arrays of a (nested) tuple, list or dict."""
    if isinstance(item, dict):
        return {k: _map(fn, v) for k, v in item.items()}
    if isinstance(item, (tuple, list)):
        return type(item)(_map(fn, v) for v in item)
    return fn(item)


class HostPrefetcher:
    """Host -> device pipeline that keeps ``depth`` transfers in flight (the
    pinned-memory/DMA overlap of the paper).  ``device`` is the card unless
    the caller asks for the CPU, where the copies are plain."""

    def __init__(self, host_iter: Iterator, device=None, depth: int = 2):
        self.host_iter = host_iter
        self.device = resolve_device(device)
        self.depth = depth
        self._queue: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self._exhausted = False
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)

    def _put(self, item):
        """Start one item's transfer; returns (tensors, ready event)."""
        if self._stream is None:
            return _map(lambda x: torch.tensor(np.asarray(x)), item), None
        with torch.cuda.stream(self._stream):
            out = _map(lambda x: torch.from_numpy(np.asarray(x)).pin_memory()
                       .to(self.device, non_blocking=True), item)
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return out, ready

    def _fill(self):
        while len(self._queue) < self.depth and not self._exhausted:
            try:
                item = next(self.host_iter)
            except StopIteration:
                self._exhausted = True
                return
            self._queue.append(self._put(item))  # transfer starts async

    def __iter__(self):
        return self

    def __next__(self):
        with self._lock:
            self._fill()
            if not self._queue:
                raise StopIteration
            out, ready = self._queue.popleft()
            if ready is not None:
                consumer = torch.cuda.current_stream(self.device)
                consumer.wait_event(ready)
                # the side stream allocated them: keep the allocator from
                # reusing their memory while the consumer's stream uses them
                _map(lambda t: t.record_stream(consumer), out)
            self._fill()  # keep the next transfers in flight
            return out


def window_batches(
    table: Table,
    series_col: str,
    window: int,
    horizon: int,
    global_batch: int,
    *,
    generator: Optional[torch.Generator] = None,
):
    """Forecasting helper: sample (window -> horizon) slices from a time
    series column, entirely on its device.  ``generator`` (on that device)
    takes the place of JAX's ``key``; without one, a generator seeded 0."""
    series = table.col(series_col)
    n = series.shape[0] - window - horizon
    if generator is None:
        generator = torch.Generator(device=series.device).manual_seed(0)
    starts = torch.randint(0, max(n, 1), (global_batch,), generator=generator,
                           device=series.device)
    idx = starts[:, None] + torch.arange(window + horizon, device=series.device)[None, :]
    data = series[idx]
    return data[:, :window], data[:, window:]
