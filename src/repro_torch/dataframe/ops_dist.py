"""Distributed dataframe operators: shuffle / sort / join / groupby /
reduce (mirror of ``repro.dataframe.ops_dist``), over either kind of mesh
(``repro_torch.launch.mesh``).

JAX runs each operator's per-shard body under ``shard_map`` and exchanges
rows with ``all_to_all`` / ``all_gather`` / ``psum``.  Here the bodies run
once over a leading shard axis: columns viewed as ``[L, per, ...]``, with
``L`` the mesh's ``n`` logical shards on one device, or ``L = 1`` on a
:class:`~repro_torch.launch.mesh.ProcessMesh`, whose Tables hold only this
rank's shard.  Only the collectives differ.  On logical shards they are
tensor operations on that layout: the tiled ``all_to_all`` a ``[src, dst,
cap]`` -> ``[dst, src, cap]`` transpose, ``all_gather`` a flatten,
``psum`` a sum.  On a process mesh they are ``torch.distributed``'s over
the axis's group: ``all_to_all_single`` of the ``[dst, cap]`` buckets,
``all_gather_into_tensor``, ``all_reduce``.  Static-shape semantics as in
JAX: every shard sends a fixed-capacity bucket to every shard; overflow
rows are dropped and *counted*.  Every rank of a process mesh holds the
same number of rows, and calls each operator with the same arguments.

Where a row lands in its destination bucket is pass 2 of a radix
partition whose pass 1, the per-destination counts, comes from the
``hash_partition_histogram`` kernel for the hash-partitioned operators
(shuffle, join and so groupby); ``sort``'s destinations come from
splitters, so it counts with plain torch.  The slots, drops and received
rows equal JAX's one-hot cumsum bit for bit.

While ``common/spans`` traces, ``groupby_sum``, ``join`` and
``reduce_sum`` record ``df.groupby_sum``, ``df.join`` and
``df.reduce_sum``; each bucket exchange ``df.exchange`` (its slots,
columns and bytes sent), and the local group-by and join
``df.local_groupby`` and ``df.local_join``, all three timed on the card
too; and each read of a card's value on the host ``df.wait``.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.common import spans
from repro_torch.dataframe import ops_local as L
from repro_torch.dataframe.table import Table
from repro_torch.kernels import ops
from repro_torch.launch.mesh import ProcessMesh


def _shards(table: Table):
    """(destination shards N, columns as [L, per, ...], valid [L, per])."""
    if table.mesh is None:
        raise ValueError("distributed operators need a Table on a mesh")
    N = table.mesh.shape[table.axis]
    L_ = 1 if isinstance(table.mesh, ProcessMesh) else N
    split = lambda c: c.reshape((L_, -1) + tuple(c.shape[1:]))  # noqa: E731
    return N, {k: split(v) for k, v in table.columns.items()}, split(table.valid)


def _table(cols: Dict, valid, like: Table) -> Table:
    """Shard-major ``[L, per, ...]`` columns back into a Table on ``like``'s
    mesh."""
    flat = lambda c: c.reshape((-1,) + tuple(c.shape[2:]))  # noqa: E731
    return Table({k: flat(v) for k, v in cols.items()}, flat(valid), like.mesh,
                 like.axis)


# -- the collectives ------------------------------------------------------------


def _all_to_all(sent: torch.Tensor, table: Table) -> torch.Tensor:
    """``[L, N(dst), cap, ...]`` buckets -> ``[L, N(src) * cap, ...]``
    received (JAX's tiled ``all_to_all`` on axis 0)."""
    N, cap = sent.shape[1:3]
    trail = tuple(sent.shape[3:])
    if not isinstance(table.mesh, ProcessMesh):
        return sent.transpose(0, 1).reshape((N, N * cap) + trail)
    wire = sent[0].to(torch.uint8) if sent.dtype == torch.bool else sent[0].contiguous()
    recv = torch.empty_like(wire)
    dist.all_to_all_single(recv, wire, group=table.mesh.group(table.axis))
    return recv.to(sent.dtype).reshape((1, N * cap) + trail)


def _all_gather(x: torch.Tensor, table: Table) -> torch.Tensor:
    """``[L, m]`` per shard -> ``[N * m]``, shard by shard."""
    if not isinstance(table.mesh, ProcessMesh):
        return x.reshape(-1)
    out = x.new_empty((table.mesh.shape[table.axis] * x.shape[1],))
    dist.all_gather_into_tensor(out, x[0].contiguous(),
                                group=table.mesh.group(table.axis))
    return out


def _psum(x: torch.Tensor, table: Table) -> torch.Tensor:
    """``[L, ...]`` per shard -> the sum over every shard of the axis."""
    x = x.sum(0)
    if isinstance(table.mesh, ProcessMesh):
        dist.all_reduce(x, group=table.mesh.group(table.axis))
    return x


def _hash_dest(keys: torch.Tensor, nshards: int) -> torch.Tensor:
    return L.hash_u32(keys) % nshards


def _hash_counts(keys, valid, nshards: int, impl: str) -> torch.Tensor:
    """[L, nshards] valid rows per destination shard, from the histogram
    kernel over each shard's keys.  Invalid rows are counted under the key
    -1 (JAX's own padding key) and that count is subtracted from the
    bucket of -1 afterwards, as the TPU kernel subtracts its padding: the
    per-shard totals are then exactly the valid rows'.  Keys are cut to
    int32 first, which keeps their low 32 bits, all the hash reads."""
    keys32 = torch.where(valid, keys, -1).to(torch.int32)
    counts = ops.hash_partition_histogram(keys32, num_buckets=nshards,
                                          impl=impl).sum(1)
    pad_bucket = int(_hash_dest(torch.tensor(-1), nshards))
    counts[:, pad_bucket] -= (~valid).sum(1)
    return counts


def _bucket_exchange(cols: Dict, valid, dest, counts, cap: int, table: Table):
    """Every shard routes its rows to destination shards with per-dest
    capacity ``cap``: row i of a shard goes to slot ``dest * cap + pos``,
    pos its rank among the shard's valid rows with its dest.  ``counts``
    [L, N] are the valid rows per dest.  Returns the received (cols
    ``[L, N * cap, ...]``, valid, rows dropped on every shard of the axis)."""
    Ls, per = valid.shape
    N = counts.shape[1]
    with spans.span("df.exchange", valid.device) as sp:
        if spans.on:
            row = sum(c.element_size() * math.prod(c.shape[2:]) for c in cols.values()) + 1
            sp.set(slots=N * cap, columns=len(cols), bytes=Ls * N * cap * row)
        # pass 2 of the radix partition: a stable sort by dest, invalid rows
        # last; a row's rank in it minus its bucket's offset is its pos
        eff = torch.where(valid, dest, N)
        sorted_dest, order = torch.sort(eff, dim=1, stable=True)
        offsets = torch.cumsum(counts, 1) - counts
        rank = torch.arange(per, device=valid.device).expand(Ls, per)
        pos_sorted = rank - torch.gather(offsets, 1, sorted_dest.clamp(max=N - 1))
        pos = torch.empty_like(pos_sorted).scatter_(1, order, pos_sorted)
        keep = valid & (pos < cap)
        lost = _psum((valid & ~keep).sum(1), table)
        with spans.wait("df.wait"):
            dropped = int(lost)
        slot = torch.where(keep, dest * cap + pos, N * cap)  # sentinel slot

        def exchange(col):
            trail = tuple(col.shape[2:])
            mask = keep.view(keep.shape + (1,) * len(trail))
            buf = col.new_zeros((Ls, N * cap + 1) + trail)
            buf.scatter_(1, slot.view(slot.shape + (1,) * len(trail)).expand(col.shape),
                         torch.where(mask, col, col.new_zeros(())))
            return _all_to_all(buf[:, :-1].view((Ls, N, cap) + trail), table)

        recv = {k: exchange(v) for k, v in cols.items()}
        return recv, exchange(keep), dropped


def shuffle(table: Table, key: str, *, capacity_factor: float = 2.0,
            impl: str = "auto"):
    """Hash-partition rows by key (Cylon shuffle).  Equal keys co-locate.
    ``impl`` picks the histogram kernel's dispatch (``kernels.ops``)."""
    nshards, cols, valid = _shards(table)
    cap = max(int(valid.shape[1] / nshards * capacity_factor), 16)
    keys = cols[key]
    recv, rvalid, dropped = _bucket_exchange(
        cols, valid, _hash_dest(keys, nshards),
        _hash_counts(keys, valid, nshards, impl), cap, table)
    return _table(recv, rvalid, table), dropped


def linspace_indices(n: int, m: int) -> np.ndarray:
    """``jnp.linspace(0, n - 1, m).astype(int32)`` as XLA computes it: the
    division by ``m - 1`` becomes a multiply by its float32 reciprocal,
    folded into the stop (``i * f32(stop * f32(1 / (m-1)))``), the last
    point is the stop itself, then truncation.  A textbook float32
    linspace (or ``torch.linspace``) is off by one at some indices, which
    moves the sort's splitters."""
    if m == 1:
        return np.zeros(1, np.int64)
    stop = np.float32(n - 1)
    step = np.float32(stop * (np.float32(1) / np.float32(m - 1)))
    pts = np.arange(m - 1, dtype=np.float32) * step
    return np.append(pts, stop).astype(np.int32).astype(np.int64)


def sample_keys(eff: torch.Tensor, m: int) -> torch.Tensor:
    """``m`` keys of each sorted shard row of ``eff`` at JAX's float32
    linspace indices, clamped into the shard.  Past 2^24 rows the last
    index rounds up to the row count, where JAX's ``jnp.take`` reads its
    fill value (INT32_MIN) as a splitter sample; the port reads the
    shard's last key (``ROADMAP.md`` queue 3, Decisions)."""
    per = eff.shape[1]
    idx = torch.as_tensor(linspace_indices(per, m), device=eff.device)
    return eff[:, idx.clamp(max=per - 1)]


def _dest_counts(dest, valid, nshards: int) -> torch.Tensor:
    """[L, nshards] valid rows per destination, counted in plain torch."""
    eff = torch.where(valid, dest, nshards)
    counts = torch.zeros((valid.shape[0], nshards + 1), dtype=torch.int64,
                         device=valid.device)
    return counts.scatter_add_(1, eff, torch.ones_like(eff))[:, :nshards]


def sort(table: Table, key: str, *, capacity_factor: float = 2.5,
         oversample: int = 8):
    """Distributed sample sort: local sort -> splitter sampling
    (all_gather) -> range partition (all_to_all) -> local merge."""
    nsh, cols, valid = _shards(table)
    per = valid.shape[1]
    cap = max(int(per * capacity_factor / nsh), 16)
    cols, valid = L.sort_by_key(cols, valid, key)
    keys = cols[key]
    eff = torch.where(valid, keys, torch.iinfo(keys.dtype).max)
    # oversample * nshards candidates per shard
    all_samples = torch.sort(_all_gather(sample_keys(eff, oversample * nsh), table)).values
    m = all_samples.shape[0]
    splitters = all_samples[torch.arange(1, nsh, device=eff.device) * m // nsh]
    dest = torch.searchsorted(splitters, eff, right=True).clamp(0, nsh - 1)
    recv, rvalid, dropped = _bucket_exchange(cols, valid, dest,
                                             _dest_counts(dest, valid, nsh), cap, table)
    recv, rvalid = L.sort_by_key(recv, rvalid, key)
    return _table(recv, rvalid, table), dropped


def join(left: Table, right: Table, key: str, *, capacity_factor: float = 2.0,
         impl: str = "auto"):
    """Distributed hash join: co-partition both sides by key hash, then
    local join (right side = build side, at most one match per left row)."""
    with spans.span("df.join"):
        nshards, lc, lv = _shards(left)
        _, rc, rv = _shards(right)
        capL = max(int(lv.shape[1] / nshards * capacity_factor), 16)
        capR = max(int(rv.shape[1] / nshards * capacity_factor), 16)
        sides = []
        for cols, valid, cap in ((lc, lv, capL), (rc, rv, capR)):
            keys = cols[key]
            sides.append(_bucket_exchange(
                cols, valid, _hash_dest(keys, nshards),
                _hash_counts(keys, valid, nshards, impl), cap, left))
        (lrecv, lrv, ldrop), (rrecv, rrv, rdrop) = sides
        with spans.span("df.local_join", lv.device):
            out, ov = L.local_hash_join(lrecv, lrv, rrecv, rrv, key)
        return _table(out, ov, left), ldrop + rdrop


def groupby_sum(table: Table, key: str, value_cols: Sequence[str], *,
                groups_cap_per_shard: int = 4096, impl: str = "auto"):
    """Distributed group-by-sum: shuffle by key, then local segment-sum."""
    with spans.span("df.groupby_sum"):
        shuffled, dropped = shuffle(table, key, impl=impl)
        _, cols, valid = _shards(shuffled)
        with spans.span("df.local_groupby", valid.device):
            keys, sums, count = L.local_groupby_sum(cols, valid, key, value_cols,
                                                    groups_cap_per_shard)
        return _table({key: keys, **sums, "_count": count}, count > 0, table), dropped


def reduce_sum(table: Table, cols: Sequence[str]) -> Dict[str, float]:
    """Sum of each column over the valid rows: per shard, then across
    shards (psum)."""
    with spans.span("df.reduce_sum"):
        _, columns, valid = _shards(table.project(list(cols)))
        out = {}
        for k, v in columns.items():
            total = _psum(torch.where(valid, v, 0).sum(1), table)
            with spans.wait("df.wait"):
                out[k] = float(total)
        return out
