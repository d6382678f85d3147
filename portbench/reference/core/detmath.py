# Frozen copy of pwnfps_tpu_torch/core/detmath.py (commit fea5a14) for the
# benchmark's plain reference.  It imports nothing of pwnfps_tpu_torch,
# pwnfps_tpu or jax; later changes to the program do not reach it.
"""Deterministic f32 sin/cos/exp (the pinned libm) on torch tensors
(pwnfps_tpu/core/detmath.py:sin_det, cos_det, exp_det).

Parity mode shares ONE implementation of these with the oracle: fixed
sequences of IEEE f32 add/mul/floor and bit ops, no fused multiply-add
and no reassociation.  Every add and mul below is its own torch op, so
nothing can contract; the float-to-int steps saturate (`to_i32`).  The
constants are the JAX package's, the split ones built from the same hex
bit patterns.  Determinism, not correct rounding, is the contract.
"""

from __future__ import annotations

import numpy as np
import torch

from .ieee import bits_f32, to_i32


def _from_bits(h: int) -> float:
    return float(torch.tensor(h, dtype=torch.int32).view(torch.float32))


def _f(v: float) -> float:
    return float(np.float32(v))


# pi/2 split with 12 zeroed low mantissa bits in HI/MID
PIO2_HI = _from_bits(0x3FC90000)      # 1.5703125
PIO2_MID = _from_bits(0x39FDA000)     # 4.8375130e-04
PIO2_LO = _from_bits(0x33A22169)      # 7.5497901e-08
TWO_OVER_PI = _from_bits(0x3F22F983)

# sin/cos kernel polynomial coefficients (fdlibm float kernels)
S1 = _f(-1.6666667163e-01)
S2 = _f(8.3333337680e-03)
S3 = _f(-1.9841270114e-04)
S4 = _f(2.7557314297e-06)
C1 = _f(4.1666667908e-02)
C2 = _f(-1.3888889225e-03)
C3 = _f(2.4801587642e-05)
C4 = _f(-2.7557314297e-07)

INV_LN2 = _from_bits(0x3FB8AA3B)
LN2_HI = _from_bits(0x3F317000)       # 0.693115234375
LN2_LO = _from_bits(0x3805F000)       # 3.1933188e-05
LN2_LO2 = _from_bits(0x325F473E)      # 1.2996507e-08
E0 = 1.0
E2 = 0.5
E3 = _f(0.16666667163581848)
E4 = _f(0.041666667908430099)
E5 = _f(0.0083333337679505348)


def _kernel_sin(r, r2):
    p = S3 + (r2 * S4)
    p = S2 + (r2 * p)
    p = S1 + (r2 * p)
    return r + ((r * r2) * p)


def _kernel_cos(r, r2):
    p = C3 + (r2 * C4)
    p = C2 + (r2 * p)
    p = C1 + (r2 * p)
    return (1.0 - (r2 * 0.5)) + ((r2 * r2) * p)


def _reduce(x):
    j = torch.floor((x * TWO_OVER_PI) + 0.5)
    r = x - (j * PIO2_HI)
    r = r - (j * PIO2_MID)
    r = r - (j * PIO2_LO)
    return r, to_i32(j) & 3


def _quadrant(n, a, b, c, d):
    return torch.where(n == 0, a, torch.where(n == 1, b,
                                              torch.where(n == 2, c, d)))


def sin_det(x: torch.Tensor) -> torch.Tensor:
    r, n = _reduce(x)
    r2 = r * r
    ks = _kernel_sin(r, r2)
    kc = _kernel_cos(r, r2)
    return _quadrant(n, ks, kc, -ks, -kc)


def cos_det(x: torch.Tensor) -> torch.Tensor:
    r, n = _reduce(x)
    r2 = r * r
    ks = _kernel_sin(r, r2)
    kc = _kernel_cos(r, r2)
    return _quadrant(n, kc, -ks, -kc, ks)


def exp_det(x: torch.Tensor) -> torch.Tensor:
    k = torch.floor((x * INV_LN2) + 0.5)
    r = x - (k * LN2_HI)
    r = r - (k * LN2_LO)
    r = r - (k * LN2_LO2)
    p = E4 + (r * E5)
    p = E3 + (r * p)
    p = E2 + (r * p)
    p = E0 + (r * p)
    p = E0 + (r * p)            # 1 + r*(1 + r*(1/2 + ...))
    e = torch.clamp(to_i32(k) + 127, 0, 254)
    out = p * bits_f32(e.to(torch.int64) << 23)
    # results at or below the normal boundary flush to zero (denormal
    # handling differs between devices; e <= 1 outputs are < 3e-38)
    return torch.where(e <= 1, torch.zeros_like(out), out)
