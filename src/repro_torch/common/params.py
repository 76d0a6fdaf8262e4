"""Parameter-spec system (mirror of ``repro.common.params``).

Models declare their parameters as nested dicts of :class:`Param` leaves,
each carrying a shape, dtype, logical axis names and an initializer tag.
``init_params`` materializes such a tree with the JAX package's init rules
(from a ``torch.Generator``, so the values differ from JAX's threefry
draws); ``from_jax_params`` carries a JAX-initialised tree across key for
key, which is how the parity tests share weights between the packages.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.launch.mesh import resolve_device

PyTree = Any


@dataclasses.dataclass(frozen=True)
class Param:
    """Declaration of a single parameter tensor."""

    shape: tuple
    axes: tuple  # logical axis name (or None) per dim; len == len(shape)
    dtype: Any = torch.float32
    init: str = "normal"  # normal | zeros | ones | embed | scaled
    scale: Optional[float] = None  # stddev override for normal/scaled

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(
                f"Param axes {self.axes} rank mismatch vs shape {self.shape}"
            )


def is_param(x: Any) -> bool:
    return isinstance(x, Param)


def map_tree(fn: Callable[[Any], Any], tree: PyTree) -> PyTree:
    """Apply ``fn`` to every leaf of a tree of nested dicts and lists
    (dict and list order kept)."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_tree(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree: PyTree) -> list:
    """The leaves of a tree of nested dicts and lists, in :func:`map_tree`
    order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, list):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def _fan_in(shape: tuple) -> int:
    # the contraction dim is by convention the second-to-last for matrices,
    # the last dim is the output.  For vectors there is no fan-in.
    if len(shape) <= 1:
        return 1
    return int(np.prod(shape[:-1]))


def _init_one(generator: torch.Generator, p: Param, device) -> torch.Tensor:
    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=p.dtype, device=device)
    if p.init == "ones":
        return torch.ones(p.shape, dtype=p.dtype, device=device)
    if p.init == "embed":
        std = p.scale if p.scale is not None else 0.02
    elif p.init in ("normal", "scaled"):
        std = p.scale if p.scale is not None else 1.0 / math.sqrt(max(_fan_in(p.shape), 1))
    else:
        raise ValueError(f"unknown init {p.init}")
    if p.dtype == torch.float32 or len(p.shape) < 2:
        x = torch.randn(p.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (x * std).to(p.dtype)
    # a low-precision tensor is drawn slice by slice along its first dim:
    # the fp32 draws of a whole stacked expert tensor would be twice its
    # size again, and then some (moonshot's in bf16: 17 GB, 35 GB of draws)
    out = torch.empty(p.shape, dtype=p.dtype, device=device)
    for i in range(p.shape[0]):
        x = torch.randn(p.shape[1:], generator=generator, dtype=torch.float32,
                        device=device)
        out[i] = (x * std).to(p.dtype)
    return out


def init_params(generator: torch.Generator, specs: PyTree,
                device=None) -> PyTree:
    """Materialize a Param tree into tensors on ``device``; ``generator``
    must live on the same device (``torch.Generator(device=...)``).
    ``None`` means the card, and raises without one: only an explicit
    ``"cpu"`` builds the tree on the CPU."""
    device = resolve_device(device)
    return map_tree(lambda p: _init_one(generator, p, device), specs)


def from_jax_params(tree: PyTree, device, dtype=None) -> PyTree:
    """Carry a JAX tree across: nested dicts and lists of numpy arrays
    (e.g. ``jax.tree.map(np.asarray, params)``, a whole train state with
    its optimizer state and 0-d int32 step, or a forecasting model's list
    of blocks) become the same nested dicts and lists of tensors on
    ``device``, key for key, shape for shape and dtype for
    dtype, cast to ``dtype`` when given.  bf16 arrays pass through fp32,
    which is exact."""
    def one(a):
        a = np.array(a)  # a writable copy: JAX hands out read-only buffers
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
        return t.to(device=device, dtype=dtype or t.dtype)

    return map_tree(one, tree)


def to_numpy(tree: PyTree) -> PyTree:
    """The reverse of :func:`from_jax_params`: every tensor of nested
    dicts and lists as a host numpy array, key for key; bf16 (which numpy
    lacks) becomes fp32, which is exact."""
    def one(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return map_tree(one, tree)


def tree_bytes(tree: PyTree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))
