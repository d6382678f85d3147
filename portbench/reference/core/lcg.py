# Frozen copy of pwnfps_tpu_torch/core/lcg.py (commit fea5a14) for the
# benchmark's plain reference.  It imports nothing of pwnfps_tpu_torch,
# pwnfps_tpu or jax; later changes to the program do not reach it.
"""The reference LCG on torch integer tensors (pwnfps_tpu/core/lcg.py).

torch has no usable uint32 arithmetic, so states live in int64 tensors
holding the uint32 value (0 <= s < 2**32) and every wrapping product is
masked back with `& 0xFFFFFFFF` (or `& 0x7FFFFFFF` where the reference
keeps 31 bits).  Products of a 32-bit and a 31-bit value fit in int64;
the full 32x32-bit products of `pixel_seed` are split into 16-bit
halves so nothing overflows.  `INV_MOD_F` stays a multiply, exactly as
the JAX package has it.  `INV_MOD_F` and `jump_coeffs` are copied from
pwnfps_tpu/core/lcg.py.
"""

from __future__ import annotations

import numpy as np
import torch

A = 25739
C = 4
MASK31 = 0x7FFFFFFF
MASK32 = 0xFFFFFFFF
MOD = 3759
# The reference builds with -ffast-math, which compiles `x / 3759.0f` into
# `x * (1.0f/3759.0f)`; the multiply form is reproduced.  f32-exact.
INV_MOD_F = float(np.float32(1.0) / np.float32(3759.0))


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


def jump_coeffs(n_max: int) -> tuple[np.ndarray, np.ndarray]:
    """(A^k mod 2^31, C_k mod 2^31) uint32 arrays for k in [0, n_max]:
    s_k = (A^k * s_0 + C_k) mod 2^31 for a 31-bit state s_0."""
    ak = np.empty(n_max + 1, np.uint32)
    ck = np.empty(n_max + 1, np.uint32)
    a, c = np.uint32(1), np.uint32(0)
    with np.errstate(over="ignore"):
        for k in range(n_max + 1):
            ak[k] = a
            ck[k] = c
            # next: A^(k+1), C_{k+1} = A*C_k + C  (all mod 2^31)
            c = (np.uint32(A) * c + np.uint32(C)) & np.uint32(MASK31)
            a = (a * np.uint32(A)) & np.uint32(MASK31)
    return ak, ck
