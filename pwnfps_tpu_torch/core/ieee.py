"""Exactly rounded f32 division and sqrt from integer ops, on torch
tensors (pwnfps_tpu/core/ieee.py:div_rn, sqrt_rn).

Parity mode needs the correctly rounded x86 divss/sqrtss results
(sphere intersection, ramp crossings).  These are the JAX package's
integer restoring algorithms, run here in int64 tensors holding the
bit patterns, so they give the same bits on every device.  Domain:
positive normal f32 in, normal f32 out; every other lane (zero,
subnormal, negative, inf, NaN, an out-of-range result) takes the IEEE
`/` or `sqrt`, as in the JAX package's jnp path.

Also the bit-level helpers the parity math shares: the f32 <-> bits
casts and `to_i32`, the saturating float-to-int conversion.
"""

from __future__ import annotations

import torch

I32 = torch.int32
I64 = torch.int64


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> i32 truncation that saturates like XLA's and CUDA's
    cvt.rzi: >= 2^31 -> INT_MAX, < -2^31 -> INT_MIN, NaN -> 0.  (torch
    on the CPU gives INT_MIN for all three.)"""
    big = x >= 2147483648.0
    r = torch.where(big | torch.isnan(x), 0.0,
                    x.clamp(min=-2147483648.0)).to(I32)
    return torch.where(big, 2147483647, r)


def f32_bits(x: torch.Tensor) -> torch.Tensor:
    """f32 -> its 32 bits as a sign-extended int64 (the int32 bitcast)."""
    return x.view(I32).to(I64)


def bits_f32(b: torch.Tensor) -> torch.Tensor:
    """Low 32 bits of an int64 tensor -> f32 with those bits."""
    b = b & 0xFFFFFFFF
    return torch.where(b >= 2 ** 31, b - 2 ** 32, b).to(I32).view(
        torch.float32)


def _round_pack(e, m24, g, sticky):
    """Round to nearest even on the guard bit g and the sticky flag,
    renormalising a mantissa carry into the exponent."""
    roundup = (g == 1) & (sticky | ((m24 & 1) == 1))
    m24 = m24 + roundup.to(I64)
    carry = m24 >= (1 << 24)
    m24 = torch.where(carry, m24 >> 1, m24)
    return e + carry.to(I64), m24


def div_rn(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Correctly rounded a / b for positive normal f32 (IEEE RN).

    Restoring long division on the mantissas: q = floor(ma*2^27 / mb)
    in (2^26, 2^28) plus a sticky remainder; round to nearest even."""
    a, b = torch.broadcast_tensors(a, b)
    ab = f32_bits(a)
    bb = f32_bits(b)
    ea = (ab >> 23) & 0xFF
    eb = (bb >> 23) & 0xFF
    ma = (ab & 0x7FFFFF) | 0x800000
    mb = (bb & 0x7FFFFF) | 0x800000
    # integer bit first (ma may exceed mb): keeps r < mb for the 27
    # fraction iterations
    ge = ma >= mb
    q = ge.to(I64)
    r = torch.where(ge, ma - mb, ma)
    for _ in range(27):
        r = r << 1
        ge = r >= mb
        r = torch.where(ge, r - mb, r)
        q = (q << 1) | ge.to(I64)
    big = q >= (1 << 27)                # quotient in [1, 2) vs [0.5, 1)
    e = ea - eb + torch.where(big, 127, 126)
    m24 = torch.where(big, q >> 4, q >> 3)
    g = torch.where(big, (q >> 3) & 1, (q >> 2) & 1)
    low = torch.where(big, q & 7, q & 3)
    e, m24 = _round_pack(e, m24, g, (low != 0) | (r != 0))
    ok = ((ea > 0) & (ea < 255) & (eb > 0) & (eb < 255)
          & (e > 0) & (e < 255) & (ab >= 0) & (bb >= 0))
    out = bits_f32((e << 23) | (m24 & 0x7FFFFF))
    return torch.where(ok, out, a / b)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded sqrt for positive normal f32 (IEEE RN).

    Digit-by-digit (restoring) root of N = M * 2^25, M the mantissa
    (doubled for odd exponents): root = floor(sqrt(N)) has 25 bits;
    guard = root bit 0, sticky = remainder."""
    xb = f32_bits(x)
    e = (xb >> 23) & 0xFF
    m = (xb & 0x7FFFFF) | 0x800000
    d = e - 127
    odd = d & 1                         # two's complement: works for d < 0
    big_m = torch.where(odd == 1, m << 1, m)    # < 2^25
    k = (d - odd) >> 1                  # floor((e - 127) / 2)
    root = torch.zeros_like(big_m)
    rem = torch.zeros_like(big_m)
    # N = M << 25: bit pair p (MSB first) is M's bits (23-2p, 24-2p);
    # pair 12 holds M's bit 0 high, pairs 13-24 are zero
    for p in range(25):
        sft = 23 - 2 * p
        if sft >= 0:
            rem = (rem << 2) | ((big_m >> sft) & 3)
        elif sft == -1:
            rem = (rem << 2) | ((big_m & 1) << 1)
        else:
            rem = rem << 2
        trial = (root << 2) | 1
        ge = rem >= trial
        rem = torch.where(ge, rem - trial, rem)
        root = (root << 1) | ge.to(I64)
    eo, m24 = _round_pack(127 + k, root >> 1, root & 1, rem != 0)
    ok = (e > 0) & (e < 255) & (xb >= 0) & (eo > 0) & (eo < 255)
    out = bits_f32((eo << 23) | (m24 & 0x7FFFFF))
    # the other lanes' IEEE sqrt, through f64: torch's vectorised f32
    # sqrt on the CPU is not always correctly rounded (1-ulp misses),
    # and f64 then f32 rounds exactly (53 >= 2*24 + 2 bits)
    return torch.where(ok, out, torch.sqrt(x.double()).float())
