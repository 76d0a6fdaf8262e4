"""The 11 NeuralForecast models of paper Table 3 (mirror of
``repro.models.forecasting``): window W -> horizon Hz univariate point
forecasting at the JAX package's widths.

Autoformer / DeepAR / NLinear / GRU / NBEATS / AutoNHITS / PatchTST / TFT /
TimesNet / VanillaTransformer / TiDE.

Each model is ``(init(key, device) -> params, apply(params, x[B,W])
-> y[B,Hz])``.  Parameters are nested dicts and lists of tensors, the JAX
package's trees key for key (``common.params.from_jax_params`` carries a
JAX tree across).  ``init`` takes a threefry key (``common/prng.py``) and
splits and folds it exactly where the JAX package's init does, so the
parameters are JAX's draws, on ``device`` (the card unless the caller
asks for the CPU).  No model reaches a kernel of its own: the matmuls,
the GRU loop over time and the small dense attention run as PyTorch ops,
as the JAX package computes them outside any Pallas kernel.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.common import prng
from repro_torch.launch.mesh import resolve_device

Model = Tuple[Callable, Callable]

_D = 64  # shared hidden width at benchmark scale


# -- helpers -----------------------------------------------------------------


def _dense(key, nin, nout, device):
    w = prng.normal(key, (nin, nout), device=device)
    return {"w": w * (1.0 / math.sqrt(nin)),
            "b": torch.zeros((nout,), device=device)}


def _apply_dense(p, x):
    return x @ p["w"] + p["b"]


def _mlp_init(key, dims, device):
    ks = prng.split(key, len(dims) - 1)
    return [_dense(k, dims[i], dims[i + 1], device) for i, k in enumerate(ks)]


def _mlp_apply(ps, x, act=F.relu):
    for i, p in enumerate(ps):
        x = _apply_dense(p, x)
        if i < len(ps) - 1:
            x = act(x)
    return x


def _gru_init(key, nin, nh, device):
    k1, k2, k3 = prng.split(key, 3)
    return {"wz": _dense(k1, nin + nh, nh, device),
            "wr": _dense(k2, nin + nh, nh, device),
            "wh": _dense(k3, nin + nh, nh, device)}


def _gru_scan(p, xs, h0):
    """xs [B, T, nin] -> (last h [B, nh], every h [B, T, nh]): the JAX
    package's ``lax.scan`` cell, stepped over time in Python."""
    h, ys = h0, []
    for t in range(xs.shape[1]):
        x = xs[:, t]
        xh = torch.cat([x, h], dim=-1)
        z = torch.sigmoid(_apply_dense(p["wz"], xh))
        r = torch.sigmoid(_apply_dense(p["wr"], xh))
        hh = torch.tanh(_apply_dense(p["wh"], torch.cat([x, r * h], dim=-1)))
        h = (1 - z) * h + z * hh
        ys.append(h)
    return h, torch.stack(ys, dim=1)


def _attn(q, k, v):
    """A small dense softmax attention (no kernel, as in the JAX package)."""
    s = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])
    return torch.softmax(s, dim=-1) @ v


def _moving_avg(x, w=13):
    """Edge-padded moving average over the last axis of [B, W]."""
    pad = F.pad(x[:, None, :], (w // 2, w - 1 - w // 2), mode="replicate")
    return F.avg_pool1d(pad, w, stride=1)[:, 0, :]


def _positions(x):
    return torch.linspace(-1, 1, x.shape[1], device=x.device)[None, :, None]


# -- models ------------------------------------------------------------------


def nlinear(W, Hz) -> Model:
    def init(key, device=None):
        return {"head": _dense(key, W, Hz, resolve_device(device))}

    def apply(p, x):
        last = x[:, -1:]
        return _apply_dense(p["head"], x - last) + last

    return init, apply


def gru(W, Hz) -> Model:
    def init(key, device=None):
        dev = resolve_device(device)
        k1, k2 = prng.split(key)
        return {"gru": _gru_init(k1, 1, _D, dev), "head": _dense(k2, _D, Hz, dev)}

    def apply(p, x):
        h, _ = _gru_scan(p["gru"], x[..., None], x.new_zeros((x.shape[0], _D)))
        return _apply_dense(p["head"], h)

    return init, apply


def deepar(W, Hz) -> Model:
    """GRU backbone emitting (mu, sigma); point forecast = mu (NLL trained
    models reported by their mean in Table 3's point metrics)."""

    def init(key, device=None):
        dev = resolve_device(device)
        k1, k2 = prng.split(key)
        return {"gru": _gru_init(k1, 1, _D, dev), "head": _dense(k2, _D, 2 * Hz, dev)}

    def apply(p, x):
        h, _ = _gru_scan(p["gru"], x[..., None], x.new_zeros((x.shape[0], _D)))
        return _apply_dense(p["head"], h)[:, :Hz]  # mu

    return init, apply


def nbeats(W, Hz, blocks=3) -> Model:
    def init(key, device=None):
        dev = resolve_device(device)
        return [{"mlp": _mlp_init(k, [W, _D, _D], dev),
                 "back": _dense(prng.fold_in(k, 1), _D, W, dev),
                 "fore": _dense(prng.fold_in(k, 2), _D, Hz, dev)}
                for k in prng.split(key, blocks)]

    def apply(ps, x):
        residual = x
        forecast = x.new_zeros((x.shape[0], Hz))
        for p in ps:
            h = _mlp_apply(p["mlp"], residual)
            residual = residual - _apply_dense(p["back"], h)
            forecast = forecast + _apply_dense(p["fore"], h)
        return forecast

    return init, apply


def autonhits(W, Hz, pools=(8, 4, 1)) -> Model:
    """NHITS: multi-rate pooling + hierarchical interpolation (pool sizes
    are closure values, not parameters)."""

    def init(key, device=None):
        dev = resolve_device(device)
        return [{"mlp": _mlp_init(k, [W // pl, _D, _D], dev),
                 "back": _dense(prng.fold_in(k, 1), _D, W, dev),
                 "fore": _dense(prng.fold_in(k, 2), _D, max(Hz // pl, 1), dev)}
                for k, pl in zip(prng.split(key, len(pools)), pools)]

    def apply(ps, x):
        residual = x
        forecast = x.new_zeros((x.shape[0], Hz))
        for p, pl in zip(ps, pools):
            pooled = residual.reshape(x.shape[0], -1, pl).mean(-1)
            h = _mlp_apply(p["mlp"], pooled)
            residual = residual - _apply_dense(p["back"], h)
            f = _apply_dense(p["fore"], h)
            # jax.image.resize(..., "linear") upsamples with half-pixel
            # centres, which is align_corners=False
            f = F.interpolate(f[:, None, :], size=Hz, mode="linear",
                              align_corners=False)[:, 0, :]
            forecast = forecast + f
        return forecast

    return init, apply


def _attn_init(key, dev):
    """q from ``key``, k and v from its fold-ins 1 and 2 (JAX's tree)."""
    return {"q": _dense(key, _D, _D, dev),
            "k": _dense(prng.fold_in(key, 1), _D, _D, dev),
            "v": _dense(prng.fold_in(key, 2), _D, _D, dev)}


def _self_attn(p, h):
    return _attn(_apply_dense(p["q"], h), _apply_dense(p["k"], h),
                 _apply_dense(p["v"], h))


def patchtst(W, Hz, patch=8) -> Model:
    def init(key, device=None):
        dev = resolve_device(device)
        k1, k2, k3, k4 = prng.split(key, 4)
        return {"embed": _dense(k1, patch, _D, dev), **_attn_init(k2, dev),
                "ff": _mlp_init(k3, [_D, 2 * _D, _D], dev),
                "head": _dense(k4, (W // patch) * _D, Hz, dev)}

    def apply(p, x):
        B = x.shape[0]
        h = _apply_dense(p["embed"], x.reshape(B, -1, patch))
        h = h + _self_attn(p, h)
        h = h + _mlp_apply(p["ff"], h)
        return _apply_dense(p["head"], h.reshape(B, -1))

    return init, apply


def vanilla_transformer(W, Hz) -> Model:
    def init(key, device=None):
        dev = resolve_device(device)
        k1, k2, k3, k4 = prng.split(key, 4)
        return {"embed": _dense(k1, 1, _D, dev), **_attn_init(k2, dev),
                "ff": _mlp_init(k3, [_D, 2 * _D, _D], dev),
                "head": _dense(k4, _D, Hz, dev)}

    def apply(p, x):
        h = _apply_dense(p["embed"], x[..., None]) + _positions(x)
        h = h + _self_attn(p, h)
        h = h + _mlp_apply(p["ff"], h)
        return _apply_dense(p["head"], h.mean(dim=1))

    return init, apply


def autoformer(W, Hz) -> Model:
    """Series decomposition + attention on the seasonal part + linear trend."""

    def init(key, device=None):
        dev = resolve_device(device)
        k1, k2 = prng.split(key)
        base = vanilla_transformer(W, Hz)[0](k1, dev)
        base["trend"] = _dense(k2, W, Hz, dev)
        return base

    def apply(p, x):
        trend = _moving_avg(x)
        seasonal = x - trend
        h = _apply_dense(p["embed"], seasonal[..., None]) + _positions(x)
        h = h + _self_attn(p, h)
        h = h + _mlp_apply(p["ff"], h)
        return (_apply_dense(p["head"], h.mean(dim=1))
                + _apply_dense(p["trend"], trend))

    return init, apply


def tft(W, Hz) -> Model:
    """Temporal fusion transformer, reduced: GRN gate + LSTM(GRU) + attn."""

    def init(key, device=None):
        dev = resolve_device(device)
        k1, k2, k3, k4 = prng.split(key, 4)
        return {"grn": _mlp_init(k1, [1, _D, _D], dev),
                "gate": _dense(prng.fold_in(k1, 1), _D, _D, dev),
                "gru": _gru_init(k2, _D, _D, dev), **_attn_init(k3, dev),
                "head": _dense(k4, _D, Hz, dev)}

    def apply(p, x):
        h = _mlp_apply(p["grn"], x[..., None], act=F.elu)
        h = h * torch.sigmoid(_apply_dense(p["gate"], h))
        _, hs = _gru_scan(p["gru"], h, x.new_zeros((x.shape[0], _D)))
        a = _attn(_apply_dense(p["q"], hs[:, -1:]), _apply_dense(p["k"], hs),
                  _apply_dense(p["v"], hs))
        return _apply_dense(p["head"], a[:, 0])

    return init, apply


def timesnet(W, Hz, k_periods=2) -> Model:
    """Top-k FFT periods -> fold to 2D -> conv (depthwise via dense on
    period dim) -> unfold; reduced TimesBlock."""

    def init(key, device=None):
        dev = resolve_device(device)
        k1, k2 = prng.split(key)
        return {"mix": _mlp_init(k1, [W, _D, W], dev), "head": _dense(k2, W, Hz, dev)}

    def apply(p, x):
        freq = torch.fft.rfft(x, dim=-1)
        # dominant-period energy re-weighting (differentiable stand-in for
        # discrete period folding, keeps the frequency-domain selection)
        weights = torch.softmax(freq.abs(), dim=-1)
        energy = torch.fft.irfft(freq * weights, n=W, dim=-1)
        h = x + _mlp_apply(p["mix"], energy)
        return _apply_dense(p["head"], h)

    return init, apply


def tide(W, Hz) -> Model:
    def init(key, device=None):
        dev = resolve_device(device)
        k1, k2, k3 = prng.split(key, 3)
        return {"enc": _mlp_init(k1, [W, _D, _D], dev),
                "dec": _mlp_init(k2, [_D, _D, Hz], dev),
                "skip": _dense(k3, W, Hz, dev)}

    def apply(p, x):
        h = _mlp_apply(p["enc"], x)
        return _mlp_apply(p["dec"], h) + _apply_dense(p["skip"], x)

    return init, apply


MODELS: Dict[str, Callable[[int, int], Model]] = {
    "Autoformer": autoformer,
    "DeepAR": deepar,
    "NLinear": nlinear,
    "GRU": gru,
    "NBEATS": nbeats,
    "AutoNHITS": autonhits,
    "PatchTST": patchtst,
    "TFT": tft,
    "TimesNet": timesnet,
    "VanillaTransformer": vanilla_transformer,
    "TiDE": tide,
}


def make_ett_series(n: int = 4096, seed: int = 0, device=None) -> torch.Tensor:
    """ETT-like synthetic series (oil-temperature style: daily + weekly
    seasonality + slow trend + noise), standardized, on ``device``: the
    JAX package's series for the same seed (its noise is JAX's threefry
    normal draw).  It is built on the host and moved to the device once,
    so it is the same series on every device (the card's division by a
    scalar multiplies by the reciprocal, which moves the phase of the
    seasonal terms by an ulp)."""
    dev = resolve_device(device)
    t = torch.arange(n, dtype=torch.float32)
    series = (
        torch.sin(2 * math.pi * t / 24.0)
        + 0.5 * torch.sin(2 * math.pi * t / (24.0 * 7))
        + 0.3 * torch.sin(2 * math.pi * t / 96.0 + 1.0)
        + 0.0005 * t
        + 0.2 * prng.normal(prng.PRNGKey(seed), (n,))
    )
    # jnp.std is the population std (ddof 0)
    return ((series - series.mean()) / series.std(correction=0)).to(dev)
