"""The reference LCG on torch integer tensors (pwnfps_tpu/core/lcg.py).

torch has no usable uint32 arithmetic, so states live in int64 tensors
holding the uint32 value (0 <= s < 2**32) and every wrapping product is
masked back with `& 0xFFFFFFFF` (or `& 0x7FFFFFFF` where the reference
keeps 31 bits).  Products of a 32-bit and a 31-bit value fit in int64;
the full 32x32-bit products of `pixel_seed` are split into 16-bit
halves so nothing overflows.  `INV_MOD_F` stays a multiply, exactly as
the JAX package has it.
"""

from __future__ import annotations

import torch

from pwnfps_tpu.core.lcg import INV_MOD_F as _INV_MOD_F

A = 25739
C = 4
MASK31 = 0x7FFFFFFF
MASK32 = 0xFFFFFFFF
MOD = 3759
INV_MOD_F = float(_INV_MOD_F)     # f32-exact: float32(1) / float32(3759)


def u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern (or any int tensor) -> int64 uint32 value."""
    return x.to(torch.int64) & MASK32


def to_i32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 holding a uint32 value -> int32 with the same 32 bits."""
    x = x & MASK32
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def mul32(a: torch.Tensor, b) -> torch.Tensor:
    """(a * b) mod 2**32 for uint32 values held in int64."""
    a_lo = a & 0xFFFF
    a_hi = a >> 16
    b_lo = b & 0xFFFF
    return (a_lo * b + (((a_hi * b_lo) & 0xFFFF) << 16)) & MASK32


def randi(seed: torch.Tensor):
    """One LCG step on uint32 states -> (new_seed, draw); draw == seed."""
    seed = (seed * A + C) & MASK31
    return seed, seed


def randfs(seed: torch.Tensor):
    """Signed uniform in [-1, 1): ((randi % 3759) * (1/3759f)) * 2 - 1."""
    seed, v = randi(seed)
    f = (v % MOD).to(torch.float32) * INV_MOD_F
    return seed, f * 2.0 - 1.0


def jump(seed: torch.Tensor, ak, ck) -> torch.Tensor:
    """31-bit state jumped k draws ahead: (A^k * s + C_k) mod 2**31."""
    return (seed * ak + ck) & MASK31


def pixel_seed(x: torch.Tensor, y: torch.Tensor, rwidth: int):
    """Per-pixel primary-ray seed (screen.h:19-21): s = x + y*y*(w+1),
    then s = s^9 in wrapping uint32 arithmetic.  Returns int64 uint32
    values."""
    s = (x + mul32(mul32(y, y), rwidth + 1)) & MASK32
    s = mul32(s, mul32(s, s))
    s = mul32(s, mul32(s, s))
    return s


def blur_row_seed(cy: torch.Tensor) -> torch.Tensor:
    """Per-scanline DoF blur seed (screen.h:82): cy*cy + 415135."""
    return (mul32(cy, cy) + 415135) & MASK32
