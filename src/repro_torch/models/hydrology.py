"""LSTM hydrology model (mirror of ``repro.models.hydrology``; paper §3.3,
Tables 1-2; He et al. arXiv:2410.15218).

Multivariate daily forcings -> LSTM -> per-target head, predicting
precipitation / mean temperature / streamflow (QObs), with NNSE reporting
as in Table 1.  ``make_camels_like`` generates a CAMELS-US-shaped synthetic
basin (seasonal forcings, snow-melt-ish lag, baseflow recession) so the
pipeline runs offline.  Its random draws are JAX's threefry draws
(``common/prng.py``), split from the seed's key as the JAX package splits
it, so the basin is the JAX package's for the same seed.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from repro_torch.common import prng
from repro_torch.launch.mesh import resolve_device

N_FEATURES = 5  # prcp, srad, tmax, tmin, vp  (CAMELS forcing set)
TARGETS = ("precipitation", "mean_temperature", "streamflow")


def lstm_init(key: torch.Tensor, n_in: int = N_FEATURES, nh: int = 64,
              n_out: int = len(TARGETS), device=None) -> Dict:
    """Parameters on ``device`` (the card unless the caller asks for the
    CPU), drawn from the threefry ``key`` as the JAX package draws them
    (its split in 5, the first three used); forget-gate bias 1."""
    dev = resolve_device(device)
    k = prng.split(key, 5)
    s = 1.0 / math.sqrt(n_in + nh)
    b = torch.zeros((4 * nh,), device=dev)
    b[nh:2 * nh] = 1.0  # forget bias 1
    return {
        "wx": prng.normal(k[0], (n_in, 4 * nh), device=dev) * s,
        "wh": prng.normal(k[1], (nh, 4 * nh), device=dev) * s,
        "b": b,
        "head_w": prng.normal(k[2], (nh, n_out), device=dev) * (1.0 / math.sqrt(nh)),
        "head_b": torch.zeros((n_out,), device=dev),
    }


def lstm_apply(params, x: torch.Tensor) -> torch.Tensor:
    """x: [B, T, F] -> predictions [B, n_out] (last-step readout); the JAX
    package's ``lax.scan`` cell, stepped over time in Python."""
    nh = params["wh"].shape[0]
    h = x.new_zeros((x.shape[0], nh))
    c = x.new_zeros((x.shape[0], nh))
    for t in range(x.shape[1]):
        z = x[:, t] @ params["wx"] + h @ params["wh"] + params["b"]
        i, f, g, o = torch.split(z, nh, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
    return h @ params["head_w"] + params["head_b"]


def nse(pred: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
    """Nash-Sutcliffe efficiency; NNSE = 1 / (2 - NSE)."""
    num = torch.sum((pred - obs) ** 2)
    den = torch.clamp(torch.sum((obs - obs.mean()) ** 2), min=1e-9)
    return 1.0 - num / den


def nnse(pred, obs):
    return 1.0 / (2.0 - nse(pred, obs))


def bucket_flow(prcp: np.ndarray, melt: np.ndarray, storage: float = 5.0) -> np.ndarray:
    """Streamflow of the simple bucket model: each day the storage takes
    that day's precipitation and melt and releases 6% of itself.  A
    sequential recursion, so it runs on the host in float32."""
    s = np.float32(storage)
    q = np.empty(len(prcp), np.float32)
    k = np.float32(0.06)
    for t, (p, m) in enumerate(zip(prcp.astype(np.float32), melt.astype(np.float32))):
        s = s + p + m
        q[t] = k * s
        s = s - q[t]
    return q


def _standardize(y: torch.Tensor, dim=None) -> torch.Tensor:
    # the population std (ddof 0), as jnp.std
    if dim is None:
        return (y - y.mean()) / (y.std(correction=0) + 1e-6)
    return (y - y.mean(dim)) / (y.std(dim=dim, correction=0) + 1e-6)


def make_camels_like(n_days: int = 5000, seed: int = 0, device=None):
    """Synthetic CAMELS-US-like basin: returns (forcings [T,F],
    targets {name: [T]}), standardized, on ``device``: the JAX package's
    basin for the same seed.  It is built on the host (the bucket
    recursion is sequential over the days) and moved to the device once."""
    ks = prng.split(prng.PRNGKey(seed), 6)

    def noise(i):
        return prng.normal(ks[i], (n_days,))

    t = torch.arange(n_days, dtype=torch.float32)
    season = torch.sin(2 * math.pi * t / 365.25)
    # forcings
    prcp = torch.relu(0.6 * season + 0.8 * noise(0) + 0.3)
    tmax = 15 + 12 * season + 2 * noise(1)
    tmin = tmax - 8 - noise(2).abs()
    srad = 200 + 150 * season + 20 * noise(3)
    vp = 8 + 5 * season + noise(4)
    # streamflow: routed precipitation with recession (simple bucket model)
    melt = torch.relu(tmin / 20.0) * 0.2
    q = torch.from_numpy(bucket_flow(prcp.numpy(), melt.numpy()))
    q = q + 0.05 * noise(5)

    feats = _standardize(torch.stack([prcp, srad, tmax, tmin, vp], dim=-1), dim=0)
    mean_temp = (tmax + tmin) / 2
    dev = resolve_device(device)
    targets = {name: _standardize(y).to(dev) for name, y in
               [("precipitation", prcp), ("mean_temperature", mean_temp),
                ("streamflow", q)]}
    return feats.to(dev), targets


def window_dataset(feats, targets, window: int = 64):
    """Sliding windows: x [N, window, F]; y [N, n_targets] (next-day)."""
    T = feats.shape[0]
    n = T - window - 1
    ar = torch.arange(n, device=feats.device)
    idx = ar[:, None] + torch.arange(window, device=feats.device)[None, :]
    x = feats[idx]
    y = torch.stack([targets[k][ar + window] for k in TARGETS], dim=-1)
    return x, y
