"""Logical-axis sharding rules -> partition specs (mirror of
``repro.distributed.sharding``).

Models annotate every parameter / activation dim with a *logical* axis name
("embed", "heads", "vocab", ...).  A rule table maps logical names to (tuples
of) physical mesh axes.  ``spec_for`` applies the table with two safeguards:

* divisibility: a mesh axis (product) that does not divide the dim size is
  dropped (the longest usable prefix of the axis tuple wins, then ``None``);
* exclusivity: a mesh axis appears at most once in a spec; the first dim
  that claims it keeps it.

A spec is a plain tuple with the entries of JAX's ``PartitionSpec`` (a mesh
axis name, a tuple of names, or ``None`` per dim, trailing ``None``\\ s
stripped), so the two compare equal with ``==``.  A mesh is anything with a
``shape`` dict of axis sizes: the port's logical and process meshes, or a
stand-in.  ``param_shardings_tree`` turns the specs into DTensor placements
over a ``torch.distributed.device_mesh.DeviceMesh``.
"""
from __future__ import annotations

import dataclasses
import types
from typing import Any, Optional, Sequence

from repro_torch.common.params import map_tree

# ---------------------------------------------------------------------------
# Rule tables
# ---------------------------------------------------------------------------

# Default rules for the production mesh (pod?, data, model).
# Weights are ZeRO-3/FSDP-sharded over ("pod","data") on their "embed"-like
# dim and tensor-parallel over "model" on their "heads"/"mlp"/"vocab" dim.
DEFAULT_RULES: dict[str, tuple] = {
    # -- weights --
    "embed": ("data",),          # FSDP shard dim
    "embed_pod": ("pod", "data"),  # alt: FSDP over pod too (set via override)
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "q_lora": ("model",),
    "kv_lora": (),               # latent rank: small, replicate
    "mlp": ("model",),
    "experts": ("model",),
    "expert_mlp": (),
    "rnn": ("model",),           # recurrent width
    "conv": (),
    "layers": (),                # stacked-layer dim: never sharded
    "stack": (),
    # -- activations --
    "act_batch": ("pod", "data"),
    "act_seq": (),
    "act_seq_sp": ("model",),  # Megatron sequence parallelism (residual stream)
    "act_embed": (),
    "act_heads": ("model",),
    "act_mlp": ("model",),
    "act_vocab": ("model",),
    "act_experts": ("model",),
    # -- kv cache (decode): sequence-split over model (flash-decoding style),
    #    because kv_heads (1..10) rarely divide a 16-way model axis.
    "cache_batch": ("pod", "data"),
    "cache_seq": ("model",),
    "cache_heads": (),
    # -- optimizer / scalar --
    "null": (),
}


def merge_rules(overrides: Optional[dict] = None) -> dict:
    rules = dict(DEFAULT_RULES)
    if overrides:
        rules.update(overrides)
    return rules


# ---------------------------------------------------------------------------
# Spec derivation
# ---------------------------------------------------------------------------


def _axis_size(mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.shape else 1


def spec_for(axes: Sequence[Optional[str]], shape: Sequence[int], mesh,
             rules: dict) -> tuple:
    """The partition spec of one tensor."""
    used: set = set()
    entries = []
    for dim, logical in zip(shape, axes):
        if logical is None:
            entries.append(None)
            continue
        if logical not in rules:
            raise KeyError(f"no sharding rule for logical axis {logical!r}")
        candidate = tuple(a for a in rules[logical] if a in mesh.shape and a not in used)
        # longest prefix whose size product divides the dim
        chosen: tuple = ()
        for k in range(len(candidate), 0, -1):
            prod = 1
            for a in candidate[:k]:
                prod *= _axis_size(mesh, a)
            if prod > 1 and dim % prod == 0:
                chosen = candidate[:k]
                break
        if not chosen:
            entries.append(None)
        else:
            used.update(chosen)
            entries.append(chosen if len(chosen) > 1 else chosen[0])
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def param_specs_tree(specs: Any, mesh, rules: Optional[dict] = None) -> Any:
    """Param tree -> spec tree."""
    rules = merge_rules(rules)
    return map_tree(lambda p: spec_for(p.axes, p.shape, mesh, rules), specs)


def placements_for(spec: tuple, mesh_axes: Sequence[str]) -> tuple:
    """A spec as DTensor placements over a mesh with dims ``mesh_axes``:
    ``Shard(d)`` on each mesh dim that tensor dim ``d``'s entry names,
    ``Replicate()`` on the others.  A dim split over several mesh axes
    (``("pod", "data")``) is split major to minor, so its axes must come
    in the mesh's order, as DTensor orders them."""
    from torch.distributed.tensor import Replicate, Shard

    owner = {}
    for d, entry in enumerate(spec):
        names = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
        where = [list(mesh_axes).index(a) for a in names]
        if where != sorted(where):
            raise ValueError(f"spec entry {entry} is not in the mesh's axis "
                             f"order {tuple(mesh_axes)}")
        owner.update({a: d for a in names})
    return tuple(Shard(owner[a]) if a in owner else Replicate() for a in mesh_axes)


def param_shardings_tree(specs: Any, device_mesh, rules: Optional[dict] = None) -> Any:
    """Param tree -> each leaf's DTensor placements over ``device_mesh``
    (a ``DeviceMesh`` with named dims): the counterpart of JAX's
    ``NamedSharding`` tree."""
    rules = merge_rules(rules)
    axes = device_mesh.mesh_dim_names
    shape = dict(zip(axes, device_mesh.mesh.shape))
    mesh = types.SimpleNamespace(shape=shape)
    return map_tree(lambda p: placements_for(spec_for(p.axes, p.shape, mesh, rules),
                                             axes), specs)


@dataclasses.dataclass(frozen=True)
class Axes:
    """Helper to annotate an activation with logical axes inside model code."""

    names: tuple

    def spec(self, shape, mesh, rules) -> tuple:
        return spec_for(self.names, shape, mesh, rules)


def constrain(x, axes: Sequence[Optional[str]], rules: Optional[dict] = None):
    """The identity.  JAX's ``constrain`` is a sharding constraint inside a
    mesh context and the identity outside one; no model of the port runs
    under a ``DeviceMesh``, so it is always outside."""
    return x
