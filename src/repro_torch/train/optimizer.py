"""Optimizers (mirror of ``repro.train.optimizer``): AdamW with a
configurable state dtype, and Adafactor with factored second moments.

Both expose ``<name>_specs`` (the state's Param tree) and
``<name>_update``.  The updates run leaf by leaf with the JAX package's
dtypes operation for operation, and write the new parameters and states
**in place** (JAX returns new trees): only one leaf's temporaries are
alive at a time, not a second copy of the whole state.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.common.params import Param, map_tree, tree_leaves
from repro_torch.configs.base import RunConfig

PyTree = Any


def _leaf_states(opt_state: PyTree, params: PyTree) -> list:
    """The per-parameter state dicts of ``opt_state`` in ``params``' leaf
    order (a state tree mirrors the parameter tree, one dict per leaf)."""
    if isinstance(params, dict):
        return [s for k in params for s in _leaf_states(opt_state[k], params[k])]
    return [opt_state]


def _apply(upd, grads, opt_state, params, *args):
    """Run ``upd(g, state, p, *args) -> (new_p, new_state)`` on each leaf
    and copy the results into ``params`` and ``opt_state`` in place."""
    with torch.no_grad():
        for g, s, p in zip(tree_leaves(grads), _leaf_states(opt_state, params),
                           tree_leaves(params)):
            new_p, new_s = upd(g, s, p, *args)
            p.copy_(new_p)
            for key, val in new_s.items():
                s[key].copy_(val)
    return params, opt_state


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def adamw_specs(param_specs: PyTree, run_cfg: RunConfig) -> PyTree:
    dt = run_cfg.opt_state_dtype
    return map_tree(lambda p: {"m": Param(p.shape, p.axes, dt, init="zeros"),
                               "v": Param(p.shape, p.axes, dt, init="zeros")},
                    param_specs)


def adamw_update(grads: PyTree, opt_state: PyTree, params: PyTree,
                 step: torch.Tensor, run_cfg: RunConfig, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8):
    """One AdamW step, in place; returns ``(params, opt_state)``.  The bias
    corrections are fp32 tensors computed from the fp32 step, as in JAX."""
    lr, wd = run_cfg.learning_rate, run_cfg.weight_decay
    t = step.float() + 1.0
    corr1 = 1.0 - b1 ** t
    corr2 = 1.0 - b2 ** t

    def upd(g, s, p):
        gf = g.float()
        m = b1 * s["m"].float() + (1 - b1) * gf
        v = b2 * s["v"].float() + (1 - b2) * gf * gf
        mhat = m / corr1
        vhat = v / corr2
        delta = mhat / (torch.sqrt(vhat) + eps) + wd * p.float()
        new_p = (p.float() - lr * delta).to(p.dtype)
        dt = s["m"].dtype
        return new_p, {"m": m.to(dt), "v": v.to(dt)}

    return _apply(upd, grads, opt_state, params)


# ---------------------------------------------------------------------------
# Adafactor (Shazeer & Stern, 2018): factored second moments
# ---------------------------------------------------------------------------


def _factored(p: Param) -> bool:
    return len(p.shape) >= 2 and p.shape[-1] >= 8 and p.shape[-2] >= 8


def adafactor_specs(param_specs: PyTree, run_cfg: RunConfig) -> PyTree:
    def per_param(p: Param):
        if _factored(p):
            return {
                "vr": Param(p.shape[:-1], p.axes[:-1], torch.float32, init="zeros"),
                "vc": Param(p.shape[:-2] + p.shape[-1:], p.axes[:-2] + p.axes[-1:],
                            torch.float32, init="zeros"),
            }
        return {"v": Param(p.shape, p.axes, torch.float32, init="zeros")}

    return map_tree(per_param, param_specs)


def adafactor_update(grads: PyTree, opt_state: PyTree, params: PyTree,
                     step: torch.Tensor, run_cfg: RunConfig, b2: float = 0.999,
                     eps: float = 1e-30, clip: float = 1.0):
    """One Adafactor step, in place; returns ``(params, opt_state)``.
    Tensor-sized math stays in the gradient's dtype (the scale and the
    clip factor are cast to it), the factored statistics in fp32, and the
    parameter update promotes as JAX does."""
    lr = run_cfg.learning_rate

    def upd(g, s, p):
        g2_mean_r = g.float().square().mean(dim=-1)
        if "vr" in s:
            g2_mean_c = g.float().square().mean(dim=-2)
            vr = b2 * s["vr"] + (1 - b2) * (g2_mean_r + eps)
            vc = b2 * s["vc"] + (1 - b2) * (g2_mean_c + eps)
            denom = torch.clamp(vr.mean(dim=-1, keepdim=True), min=eps)
            precond = (vr[..., None] / denom[..., None]) * vc[..., None, :]
            scale = torch.rsqrt(torch.clamp(precond, min=eps)).to(g.dtype)
            update = g * scale
            new_s = {"vr": vr, "vc": vc}
        else:
            v = b2 * s["v"] + (1 - b2) * (g.float().square() + eps)
            update = g * torch.rsqrt(torch.clamp(v, min=eps)).to(g.dtype)
            new_s = {"v": v}
        # update clipping (RMS): reduction in fp32, scaling in g's dtype
        rms = torch.sqrt(update.float().square().mean() + eps)
        factor = (1.0 / torch.clamp(rms / clip, min=1.0)).to(g.dtype)
        # JAX promotes (lr * factor) [g's dtype] against p's dtype; a 0-d
        # torch tensor would not, so the promotion is spelled out
        dt = torch.promote_types(g.dtype, p.dtype)
        new_p = p.to(dt) - (lr * factor).to(dt) * update.to(p.dtype).to(dt)
        return new_p.to(p.dtype), new_s

    return _apply(upd, grads, opt_state, params)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def opt_specs(param_specs: PyTree, run_cfg: RunConfig) -> PyTree:
    if run_cfg.optimizer == "adafactor":
        return adafactor_specs(param_specs, run_cfg)
    return adamw_specs(param_specs, run_cfg)


def opt_update(grads, opt_state, params, step, run_cfg: RunConfig):
    if run_cfg.optimizer == "adafactor":
        return adafactor_update(grads, opt_state, params, step, run_cfg)
    return adamw_update(grads, opt_state, params, step, run_cfg)
