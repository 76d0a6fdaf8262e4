"""GPipe-style pipeline parallelism over a process mesh's ``pipe`` axis
(mirror of ``repro.distributed.pipeline_par``).

Layers split into S stages, one per rank of the axis; microbatches stream
through with the fill-drain schedule of ``n_micro + S - 1`` ticks: each
tick every stage applies its layers to the microbatch it holds and hands
the activation to the next stage by point-to-point send / recv (JAX's
non-cyclic ``ppermute``; stage 0 reads its queue).  A stage computes and
sends only on the ticks where it holds a microbatch: JAX computes on every
tick and zeroes the idle ones, which sends the same values.  On gloo the
messages go through host copies (``ProcessMesh.p2p_device``).
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.common.params import map_tree


def pipeline_forward(
    stage_fn: Callable,      # stage_fn(stage_params, x) -> y  (one stage)
    stage_params,            # tree with leading [n_stages, ...] dims
    x_micro: torch.Tensor,   # [n_micro, micro_batch, ...], the same on every rank
    mesh,                    # a ProcessMesh
    axis: str = "pipe",
) -> torch.Tensor:
    """Returns the ``[n_micro, micro_batch, ...]`` outputs (all stages
    applied) on every rank of the axis."""
    S = mesh.shape[axis]
    stage = mesh.coords[axis]
    group = mesh.group(axis)
    n_micro = x_micro.shape[0]
    params = map_tree(lambda p: p[stage], stage_params)
    peer = lambda s: dist.get_global_rank(group, s)  # noqa: E731
    outputs = torch.zeros_like(x_micro)
    hold = None
    for t in range(n_micro + S - 1):
        if stage <= t < stage + n_micro:
            y = stage_fn(params, x_micro[t] if stage == 0 else hold)
            if stage == S - 1:
                outputs[t - stage] = y
            else:
                dist.send(y.to(mesh.p2p_device).contiguous(), peer(stage + 1), group=group)
        if stage > 0 and stage - 1 <= t < stage - 1 + n_micro:
            buf = torch.empty(x_micro.shape[1:], dtype=x_micro.dtype,
                              device=mesh.p2p_device)
            dist.recv(buf, peer(stage - 1), group=group)
            hold = buf.to(mesh.device)
    dist.broadcast(outputs, peer(S - 1), group=group)
    return outputs
