"""Counter-based random streams, bit-for-bit those of ``jax.random``.

Counterpart of ``rust_ray_tracer_tpu/utils/rng.py`` (``wave_key``,
``bounce_key``, ``stream`` and the stream tags) plus the pieces of
``jax.random`` the renderer draws through: ``PRNGKey``, ``fold_in``,
``uniform`` and ``normal`` with ``jax_threefry_partitionable=True`` (the
jax 0.9 default).

The renderer's contract is that an image depends only on
``(seed, chunk_size)``; the port keeps that contract by reproducing the
JAX streams exactly, so the same seed renders the same paths in both
packages. ``torch.Generator`` cannot do that.

A key is an int64 tensor ``[..., 2]`` holding two uint32 words. uint32
arithmetic is emulated in int64 with a 32-bit mask; every function takes
batches of keys (leading dimensions) so one call draws the randoms of a
whole wave. This is plain tensor glue, not a kernel.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from rust_ray_tracer_tpu_torch.utils import device as device_mod

# Stable stream tags. Never renumber — that silently changes every render.
JITTER = 0       # per-sample pixel jitter (main.rs:92-93)
TIME = 1         # camera shutter time (camera.rs:67)
SCATTER = 2      # diffuse mixture sampling (pdf.rs:72-95)
FUZZ = 3         # metal fuzz ball sampling (material/mod.rs:96)
COIN = 4         # dielectric reflect/refract coin (material/mod.rs:130)
MEDIUM = 5       # constant-medium free-flight distance (constant_medium.rs:63)
ISO = 6          # isotropic uniform ball direction (material/mod.rs:209)
LIGHT_PICK = 7   # uniform light selection (geometry/mod.rs:122-125)
LIGHT_SAMPLE = 8  # per-light direction sampling (sphere.rs:114 / aarect.rs:134)
MIX_COIN = 9     # 50/50 mixture component choice (pdf.rs:87-94)
CHUNK = 10       # per-ray-chunk key derivation (integrator)

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# nextafter(-1, 0) in float32: jax.random.normal's lower uniform bound
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
# XLA's float32 ErfInv polynomial (w < 5 and w >= 5 branches)
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)
# XLA's CPU float32 log1p: a Cephes rational for |x| < sqrt(2) - 1, else
# its polynomial log of 1 + x (float32 values of its constants)
_LOG1P_SMALL = 0.4142135679721832
_LOG1P_DEN = (15.062909126281738, 83.04756927490234, 221.7624053955078,
              309.0987243652344, 216.42788696289062, 60.11865997314453)
_LOG1P_NUM = (4.527000055531971e-05, 0.4985410273075104, 6.578732490539551,
              29.91191864013672, 60.949668884277344, 57.11296463012695,
              20.039552688598633)
_LOG_SQRTHF = 0.7071067690849304
_LOG_P = ((0.07037683576345444, -0.11514610052108765, 0.11676998436450958),
          (-0.12420140951871872, 0.14249323308467865, -0.16668057441711426),
          (0.2000071406364441, -0.24999994039535522, 0.3333333134651184))
_LOG_Q1 = -0.00021219444170128554       # log(2) split: Q1 + Q2
_LOG_Q2 = 0.693359375


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds), as XLA lowers it.

    All four arguments are int64 tensors of uint32 values that broadcast
    together; returns the two hashed words.
    """
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    y0 = (x1 + ks[0]) & _M32
    y1 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            y0 = (y0 + y1) & _M32
            y1 = _rotl(y1, r) ^ y0
        y0 = (y0 + ks[(i + 1) % 3]) & _M32
        y1 = (y1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return y0, y1


def key(seed: int, device=device_mod.DEFAULT) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for 0 <= seed < 2**32: words (0, seed),
    on ``device`` (the card unless ``device="cpu"``; raises without one)."""
    if not 0 <= seed <= _M32:
        raise ValueError(f"seed must be in [0, 2**32), got {seed}")
    return torch.tensor([0, seed], dtype=torch.int64,
                        device=device_mod.resolve(device))


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: hash the count pair (0, data) under ``k``.

    ``k`` is ``[..., 2]``; ``data`` an int or an integer tensor that
    broadcasts against ``k[..., 0]``.
    """
    data = torch.as_tensor(data, dtype=torch.int64, device=k.device) & _M32
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def wave_key(root: torch.Tensor, wave) -> torch.Tensor:
    """Key for one sample-wave (one spp pass over all pixels)."""
    return fold_in(root, wave)


def bounce_key(wkey: torch.Tensor, bounce) -> torch.Tensor:
    return fold_in(wkey, bounce)


def stream(k: torch.Tensor, purpose: int) -> torch.Tensor:
    return fold_in(k, purpose)


def random_bits(k: torch.Tensor, shape) -> torch.Tensor:
    """32-bit draws ``[..., *shape]`` for keys ``[..., 2]``: the
    partitionable layout hashes the flat element index (high, low words)
    and xors the two outputs."""
    shape = tuple(shape)
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=k.device)
    lead = k.shape[:-1]
    k1 = k[..., 0].reshape(lead + (1,))
    k2 = k[..., 1].reshape(lead + (1,))
    y0, y1 = threefry2x32(k1, k2, idx >> 32, idx & _M32)
    return (y0 ^ y1).reshape(lead + shape)


def uniform(k: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.uniform(k, shape, float32)`` in [0, 1): the top 23
    bits become the mantissa of a float in [1, 2), minus one."""
    bits = random_bits(k, shape)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def _fma(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` with one rounding, as XLA's CPU code fuses it:
    the float32 product is exact in float64, so the float64 sum rounded to
    float32 is the fused result (up to a double rounding on exact ties)."""
    def f64(v):
        return v.double() if torch.is_tensor(v) else v
    return (f64(a) * f64(b) + f64(c)).to(torch.float32)


def _log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 ``log1p``, operation for operation (its products
    fused into FMAs where XLA's code fuses them), so it is bitwise on any
    backend that rounds float32 and float64 arithmetic correctly."""
    f32 = torch.float32
    zero = torch.zeros((), dtype=f32, device=x.device)
    # large |x|: log(v), v = 1 + x = m * 2^e with m in [sqrt(1/2), sqrt(2))
    v = x + 1.0
    tiny = torch.tensor(2.0 ** -126, dtype=f32, device=x.device)
    bits = torch.where(v > tiny, v, tiny).view(torch.int32)
    e = ((bits >> 23) - 127).to(f32)
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(f32)          # [0.5, 1)
    lo = m < _LOG_SQRTHF
    f = (m - 1.0) + torch.where(lo, m, zero)
    e = (e + 1.0) - lo.to(f32)
    f2 = f * f
    f3 = f2 * f
    a, b, c = (_fma(_fma(f, p0, p1), f, p2) for p0, p1, p2 in _LOG_P)
    poly = _fma(_fma(_fma(a, f3, b), f3, c), f3, e * _LOG_Q1)
    big = _fma(e, _LOG_Q2, (f - f2 * 0.5) + poly)
    big = torch.where(v == 0, -math.inf,
                      torch.where(v == math.inf, math.inf,
                                  torch.where(v < 0, math.nan, big)))
    # small |x|: x - x^2/2 + x^3 * num(x) / den(x)
    den = x + _LOG1P_DEN[0]
    for k in _LOG1P_DEN[1:]:
        den = _fma(den, x, k)
    num = _fma(_LOG1P_NUM[0], x, _LOG1P_NUM[1])
    for k in _LOG1P_NUM[2:]:
        num = _fma(num, x, k)
    x2 = x * x
    small = x + _fma(x2, -0.5, (x * x2) * (num / den))
    return torch.where(x.abs() < _LOG1P_SMALL, small, big)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ErfInv (Giles' polynomial), not ``torch.erfinv``:
    ``log1p`` and the Horner steps are XLA's own, fused where XLA fuses
    them, so the result is bitwise ``jax.lax.erf_inv`` on the CPU."""
    w = -_log1p(-x * x)
    lt = w < 5.0
    # XLA's float32 sqrt is correctly rounded; torch's vectorised CPU one
    # is not (0.7% of values in [5, 20) come out an ulp off on an AVX512
    # CPU), while the float64 root rounded to float32 is
    sqrt_w = torch.sqrt(w.double()).to(x.dtype)
    w = torch.where(lt, w - 2.5, sqrt_w - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0]).to(x.dtype)
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, w, torch.where(lt, a, b).to(x.dtype))
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal(k: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.normal(k, shape, float32)``: sqrt(2) * erfinv of a
    uniform on (nextafter(-1, 0), 1)."""
    u01 = uniform(k, shape)
    lo = torch.tensor(_NORMAL_LO, dtype=torch.float32, device=k.device)
    span = torch.tensor(1.0, dtype=torch.float32, device=k.device) - lo
    u = torch.maximum(lo, u01 * span + lo)
    return float(np.float32(np.sqrt(2.0))) * erf_inv(u)
