"""Local (per-shard) dataframe operators (mirror of
``repro.dataframe.ops_local``): mask-aware and static-shape.

Every operator takes one shard (``valid [per]``, columns ``[per, ...]``)
or all shards at once (``valid [S, per]``, columns ``[S, per, ...]``): the
row axis is ``valid``'s last, and the leading shard axis is batched
through (batched sort, searchsorted and offset scatters), so one launch
serves every shard.  Sorts are stable wherever jnp's are.

One deliberate difference from JAX: ``local_groupby_sum`` reports each
group's own key where JAX reports 0 for a negative key (ROADMAP.md queue
3).
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch

from repro_torch.kernels.ref import hash_u32_ref

# the uint32 multiplicative hash, as int64 values in [0, 2^32)
hash_u32 = hash_u32_ref


def _take_rows(col: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``col[..., idx, ...]`` along the row axis (``idx.ndim - 1``), per
    shard: ``idx`` has ``valid``'s shape, ``col`` may have trailing dims."""
    axis = idx.ndim - 1
    if col.ndim > idx.ndim:
        idx = idx.reshape(idx.shape + (1,) * (col.ndim - idx.ndim))
        idx = idx.expand(idx.shape[:axis + 1] + col.shape[axis + 1:])
    return torch.gather(col, axis, idx)


def _big(dtype: torch.dtype):
    """The sort key of an invalid row: the dtype's largest value."""
    return torch.iinfo(dtype).max if not dtype.is_floating_point else float("inf")


def filter_rows(columns: Dict, valid: torch.Tensor, mask: torch.Tensor):
    """Logical filter: rows stay in place, validity shrinks (static shape)."""
    return columns, valid & mask


def sort_by_key(columns: Dict, valid: torch.Tensor, key: str, *,
                descending: bool = False):
    """Local sort by key; invalid rows sort to the end (stable)."""
    keys = columns[key]
    eff = torch.where(valid, -keys if descending else keys, _big(keys.dtype))
    order = torch.sort(eff, dim=-1, stable=True).indices
    cols = {k: _take_rows(v, order) for k, v in columns.items()}
    return cols, torch.gather(valid, -1, order)


def compact(columns: Dict, valid: torch.Tensor):
    """Move valid rows to the front (stable), keep capacity."""
    order = torch.sort((~valid).to(torch.uint8), dim=-1, stable=True).indices
    cols = {k: _take_rows(v, order) for k, v in columns.items()}
    return cols, torch.gather(valid, -1, order)


def _slot_index(seg: torch.Tensor, slots: int) -> torch.Tensor:
    """Flat index of each row's slot, every shard's ``slots`` slots laid
    end to end (so one scatter serves every shard)."""
    lead = seg.shape[:-1]
    base = torch.arange(math.prod(lead), device=seg.device).view(lead + (1,))
    return (seg + base * slots).reshape(-1)


def _per_shard(flat_out: torch.Tensor, lead, slots: int) -> torch.Tensor:
    """``[shards * slots, ...]`` -> ``[..., slots - 1, ...]``: back to the
    shard layout, the sentinel slot dropped."""
    out = flat_out.view(tuple(lead) + (slots,) + tuple(flat_out.shape[1:]))
    return out.narrow(len(lead), 0, slots - 1)


def local_groupby_sum(columns: Dict, valid: torch.Tensor, key: str,
                      value_cols: Sequence[str], num_groups_cap: int):
    """Group-by-key sum into fixed slots (keys assumed pre-partitioned so
    equal keys are co-located).  Sort-based segmenting: exact, no hash
    collisions; distinct keys beyond ``num_groups_cap`` are dropped.
    Returns ``(key_of_slot, sums, count)``, each ``[..., cap]``; an empty
    slot has key 0."""
    # only the key and the summed columns are sorted (JAX sorts them all)
    cols, valid = sort_by_key({c: columns[c] for c in (key, *value_cols)}, valid, key)
    keys = cols[key]
    first = torch.ones_like(valid)
    first[..., 1:] = keys[..., 1:] != keys[..., :-1]
    first &= valid
    seg = torch.cumsum(first.to(torch.int64), dim=-1) - 1  # group of each row
    seg = torch.where(valid & (seg < num_groups_cap), seg, num_groups_cap)
    lead, slots = valid.shape[:-1], num_groups_cap + 1  # + the sentinel slot
    flat = _slot_index(seg, slots)
    nslots = math.prod(lead) * slots

    def segment_sum(v):
        trail = tuple(v.shape[valid.ndim:])
        v = torch.where(valid.view(valid.shape + (1,) * len(trail)), v, 0)
        out = v.new_zeros((nslots,) + trail)
        return _per_shard(out.index_add_(0, flat, v.reshape((-1,) + trail)),
                          lead, slots)

    sums = {c: segment_sum(cols[c]) for c in value_cols}
    # every row of a group has the group's key: the max over the group's
    # rows alone (JAX's max also takes the slot's initial 0, so a negative
    # key reads 0)
    key_of_slot = _per_shard(keys.new_zeros((nslots,)).scatter_reduce_(
        0, flat, torch.where(valid, keys, 0).reshape(-1), "amax",
        include_self=False), lead, slots)
    count = segment_sum(valid.to(torch.int32))
    return key_of_slot, sums, count


def local_hash_join(
    left_cols: Dict, left_valid: torch.Tensor,
    right_cols: Dict, right_valid: torch.Tensor,
    key: str, suffix: str = "_r",
) -> Tuple[Dict, torch.Tensor]:
    """Inner equality join; the right side is the (deduplicated) build
    side: each left row matches at most one right row (the first in key
    order).  Output capacity == left capacity (static)."""
    lk = left_cols[key]
    rk = right_cols[key]
    rk_eff = torch.where(right_valid, rk, torch.iinfo(rk.dtype).max)
    rk_sorted, order = torch.sort(rk_eff, dim=-1, stable=True)
    dt = torch.promote_types(lk.dtype, rk.dtype)
    pos = torch.searchsorted(rk_sorted.to(dt), lk.to(dt).contiguous())
    pos = pos.clamp(0, rk_sorted.shape[-1] - 1)
    match = (torch.gather(rk_sorted, -1, pos) == lk) & left_valid
    ridx = torch.gather(order, -1, pos)
    out = dict(left_cols)
    for k, v in right_cols.items():
        if k == key:
            continue
        name = k if k not in left_cols else k + suffix
        out[name] = _take_rows(v, ridx)
    return out, match
