"""Seeded weights, made by the benchmark on the device in the type they
are served in: every matrix normal(0, initializer_range), every norm
scale ones, one ``normal_`` call a tensor from one ``torch.Generator`` on
the device (the program's tree stacks a unit's layers, so a tensor is
all layers of one kind).  Both the program and the reference are handed
these tensors; neither makes its own."""
from __future__ import annotations

from typing import Any, Dict

import torch


def walk(tree, path=()):
    """(path, leaf) of a tree of nested dicts, in insertion order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from walk(v, path + (k,))
    else:
        yield path, tree


def set_leaf(tree: Dict, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def make(shapes: Any, seed: int, device, dtype, std: float,
         live_heads: int = 0, kv_heads: int = 0) -> Dict:
    """A tree of tensors shaped as ``shapes`` (the program's parameter
    declarations: leaves with ``.shape`` and ``.init``).  Where the
    program pads the query heads to a multiple (``live_heads`` published
    heads over ``kv_heads`` groups, laid out group-major), each group's
    padded heads are zero in ``wq`` and ``wo``, so the model is the
    published one."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out: Dict = {}
    for path, spec in walk(shapes):
        t = torch.empty(tuple(spec.shape), dtype=dtype, device=device)
        if spec.init == "ones":
            t.fill_(1.0)
        elif spec.init == "zeros":
            t.zero_()
        else:
            t.normal_(0.0, std, generator=gen)
        if live_heads and path[-1] in ("wq", "wo"):
            zero_pad_heads(t, path[-1], live_heads, kv_heads)
        set_leaf(out, path, t)
    return out


def zero_pad_heads(t: torch.Tensor, name: str, live: int, kv: int) -> None:
    """Zero the padded heads of ``wq`` ([..., d, H, D]) or ``wo`` ([..., H,
    D, d]): in each of the ``kv`` groups the heads past its live ones."""
    axis = t.dim() - 2 if name == "wq" else t.dim() - 3
    gp, gl = t.shape[axis] // kv, live // kv
    if gp == gl:
        return
    v = t.unflatten(axis, (kv, gp))
    v.narrow(axis + 1, gl, gp - gl).zero_()
