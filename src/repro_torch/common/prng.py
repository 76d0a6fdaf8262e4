"""JAX's threefry random numbers in torch (``jax.random`` with
``jax_threefry_partitionable=True``, bit for bit).

A key is an int64 tensor whose last axis holds the two 32-bit words of a
``jax.random.PRNGKey``; leading axes batch keys.  torch has no unsigned
32-bit arithmetic on every device, so every word is an int64 in
``[0, 2^32)``, masked after each add and shift.  Integer results (keys,
bits, ``randint``) are the same on every device and equal JAX's; the
floats of ``uniform`` are built from the bits exactly as JAX builds them;
``normal`` runs XLA's single-precision ``erf_inv`` (Giles' polynomial over
XLA:CPU's own ``log1p``, with its fused multiply-adds emulated in float64)
in torch ops, so it equals JAX's on the CPU.

Every draw takes ``shape`` as an int or a tuple; a key of shape
``[..., 2]`` gives a result of shape ``[..., *shape]``, each leading key
with its own stream, as ``jax.vmap`` over the keys would.  The counter of
an element is its flat index in ``shape``, split in its high and low 32
bits (``iota_2x32_shape``).
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

MASK = 0xFFFFFFFF
# threefry2x32's rotations, alternating every four rounds, and the key
# schedule's parity constant
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

Shape = Union[int, Sequence[int]]

# XLA's ErfInv32 (Giles, "Approximating the erfinv function"): the
# coefficients for w < 5 and for w >= 5, highest degree first
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, (int, np.integer)) else tuple(shape)


def PRNGKey(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: without x64 JAX keeps the seed's low
    32 bits, so the key is ``[0, seed mod 2^32]``."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64, device=device)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1, x2):
    """The threefry2x32 hash of the counter words ``(x1, x2)`` under the
    key ``(k1, k2)``: int64 tensors of 32-bit words, broadcast together
    -> the two hashed words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x1, x2


def _hash_counts(keys: torch.Tensor, shape: Tuple[int, ...], device=None):
    """Each key ``[..., 2]`` over the counter ``0 .. prod(shape) - 1`` ->
    the two hashed words ``[..., *shape]``."""
    dev = keys.device if device is None else torch.device(device)
    keys = keys.to(dev)
    n = math.prod(shape)
    count = torch.arange(n, dtype=torch.int64, device=dev)
    lead = keys.shape[:-1]
    k1 = keys[..., 0].reshape(*lead, 1)
    k2 = keys[..., 1].reshape(*lead, 1)
    w1, w2 = threefry2x32(k1, k2, count >> 32, count & MASK)
    return w1.reshape(*lead, *shape), w2.reshape(*lead, *shape)


def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``[..., 2]`` -> ``[..., num, 2]``."""
    w1, w2 = _hash_counts(keys, (num,))
    return torch.stack([w1, w2], dim=-1)


def fold_in(keys: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in`` of a 32-bit integer: the hash of the
    counter ``(0, data)``, which is also ``split(key, data + 1)[data]``."""
    k1, k2 = keys[..., 0], keys[..., 1]
    zero = torch.zeros_like(k1)
    w1, w2 = threefry2x32(k1, k2, zero, zero + (int(data) & MASK))
    return torch.stack([w1, w2], dim=-1)


def random_bits(keys: torch.Tensor, shape: Shape, device=None) -> torch.Tensor:
    """``jax.random.bits`` (32-bit): the two hashed words xor-ed, as int64
    in ``[0, 2^32)``."""
    w1, w2 = _hash_counts(keys, _shape(shape), device)
    return w1 ^ w2


def _f32(c: float) -> float:
    return float(np.float32(c))


def _fma(a, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once to float32, as XLA:CPU's contracted
    multiply-adds compute it: the float32 product is exact in float64."""
    a, b, c = (t.double() if isinstance(t, torch.Tensor) else t for t in (a, b, c))
    return (a * b + c).float()


def uniform(keys: torch.Tensor, shape: Shape, minval: float = 0.0,
            maxval: float = 1.0, device=None) -> torch.Tensor:
    """``jax.random.uniform`` in float32: the top 23 bits as the mantissa
    of a float in [1, 2), minus 1, scaled into [minval, maxval) by one
    multiply-add (XLA contracts it) and floored at minval."""
    bits = (random_bits(keys, shape, device) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=floats.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=floats.device)
    return torch.maximum(lo, _fma(floats, hi - lo, lo))


# XLA:CPU's float32 log (Cephes' logf, the polynomial in three parts) and
# log1p (Cephes' rational approximation below sqrt(2) - 1, else log(1 + x))
_LOG_P = tuple(_f32(c) for c in (
    7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1, -1.2420140846E-1,
    1.4249322787E-1, -1.6668057665E-1, 2.0000714765E-1, -2.4999993993E-1,
    3.3333331174E-1))
_LOG1P_NUM = tuple(_f32(c) for c in (
    4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
    6.5787325942061044846969E0, 2.9911919328553073277375E1,
    6.0949667980987787057556E1, 5.7112963590585538103336E1,
    2.0039553499201281259648E1))
_LOG1P_DEN = tuple(_f32(c) for c in (
    1., 1.5062909083469192043167E1, 8.3047565967967209469434E1,
    2.2176239823732856465394E2, 3.0909872225312059774938E2,
    2.1642788614495947685003E2, 6.0118660497603843919306E1))


def _xla_log(y: torch.Tensor) -> torch.Tensor:
    """float32 log of positive ``y`` in XLA:CPU's order of operations."""
    y = torch.clamp(y, min=float(np.finfo(np.float32).tiny))
    m, e = torch.frexp(y)
    e = e.float()
    small = m < _f32(0.707106781186547524)
    x = torch.where(small, m + m - 1.0, m - 1.0)
    e = torch.where(small, e - 1.0, e)
    x2 = x * x
    x3 = x2 * x
    p = _LOG_P
    y0 = _fma(_fma(x, p[0], p[1]), x, p[2])
    y1 = _fma(_fma(x, p[3], p[4]), x, p[5])
    y2 = _fma(_fma(x, p[6], p[7]), x, p[8])
    y0 = _fma(_fma(y0, x3, y1), x3, y2)
    y0 = _fma(y0, x3, e * _f32(-2.12194440e-4))
    x = _fma(-0.5, x2, x) + y0
    return _fma(e, _f32(0.693359375), x)


def _xla_log1p(x: torch.Tensor) -> torch.Tensor:
    """float32 log1p in XLA:CPU's order of operations."""
    x2 = x * x
    num = torch.zeros_like(x)
    den = torch.zeros_like(x)
    for cn, cd in zip(_LOG1P_NUM, _LOG1P_DEN):
        num = _fma(num, x, cn)
        den = _fma(den, x, cd)
    small = _fma(-0.5, x2, (x * x2) * (num / den)) + x
    return torch.where(x.abs() < _f32(0.41421356237309504880), small,
                       _xla_log(x + 1.0))


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """``jax.lax.erf_inv`` in float32, as XLA:CPU computes it: Giles'
    polynomial in ``w = -log1p(-x^2)`` with contracted multiply-adds;
    +-inf at +-1."""
    w = -_xla_log1p(x * -x)
    lt = w < 5.0
    # a correctly rounded float32 sqrt, as XLA's
    w = torch.where(lt, w - 2.5, torch.sqrt(w.double()).float() - 3.0)
    c = [torch.where(lt, _f32(a), _f32(b))
         for a, b in zip(_ERFINV_LT5, _ERFINV_GE5)]
    p = c[0]
    for ci in c[1:]:
        p = _fma(p, w, ci)
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2)))


def normal(keys: torch.Tensor, shape: Shape, device=None) -> torch.Tensor:
    """``jax.random.normal`` in float32: ``sqrt(2) * erf_inv(u)`` of ``u``
    uniform in ``(-1, 1)``."""
    u = uniform(keys, shape, _NORMAL_LO, 1.0, device)
    return _SQRT2 * erf_inv(u)


def randint(keys: torch.Tensor, shape: Shape, minval: int, maxval: int,
            device=None) -> torch.Tensor:
    """``jax.random.randint`` to int32: two words per value (from the two
    halves of ``split(key)``), reduced modulo the span in uint32
    arithmetic (int64 masked to 32 bits); a span below 1 gives
    ``minval``."""
    shape = _shape(shape)
    k = split(keys, 2)
    hi = random_bits(k[..., 0, :], shape, device)
    lo = random_bits(k[..., 1, :], shape, device)
    span = (maxval - minval) & MASK if maxval > minval else 1
    mult = ((2 ** 16 % span) ** 2 & MASK) % span  # the square wraps in uint32
    offset = ((((hi % span) * mult) & MASK) + lo % span) & MASK
    return (minval + offset % span).to(torch.int32)
