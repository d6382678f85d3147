"""Bit-exact emulation of the SSE approximate intrinsics on torch tensors
(pwnfps_tpu/core/approx.py).  `SseTables` is copied from there.

The reference's image depends on two ~12-bit approximations:
`_mm_rsqrt_ps` inside v_normalise (util.h:43) and `_mm_rcp_ps` for the
DDA inverse velocity (trace.h:231).  On x86 both are lookup tables
indexed by the exponent parity (rsqrt only) and the top 12 mantissa
bits, scaled by an exact power of two.  The tables, dumped from the
host CPU by the oracle harness, live in assets/tables/sse_tables.bin.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .ieee import bits_f32

BLOCK = 11  # low mantissa bits ignored by the approximation

_DEFAULT_TABLE_PATH = os.path.join(
    os.path.dirname(__file__), "..", "..", "assets", "tables",
    "sse_tables.bin")


class SseTables:
    """rsqrt [8192] + rcp [4096] uint32 result-bit tables."""

    def __init__(self, rsqrt: np.ndarray, rcp: np.ndarray):
        if rsqrt.shape != (8192,) or rcp.shape != (4096,):
            raise ValueError(f"table shapes {rsqrt.shape} {rcp.shape}, "
                             "want (8192,) and (4096,)")
        self.rsqrt = rsqrt.astype(np.uint32)
        self.rcp = rcp.astype(np.uint32)

    @classmethod
    def load(cls, path: str | None = None) -> "SseTables":
        path = path or _DEFAULT_TABLE_PATH
        raw = np.fromfile(path, np.uint32)
        magic, block, ok_block, ok_scale = raw[:4]
        if magic != 0x52535154 or block != BLOCK:
            raise ValueError(f"{path}: not an SSE table dump for "
                             f"BLOCK={BLOCK}")
        if ok_block != 1 or ok_scale != 1:
            raise ValueError(f"{path}: the host CPU's rsqrt/rcp did not "
                             "match the table structure")
        return cls(raw[4:4 + 8192], raw[4 + 8192:4 + 8192 + 4096])


def _split(x: torch.Tensor):
    """(biased exponent incl. the sign bit, mantissa) of f32 x, as the
    JAX package's numpy path takes them from the uint32 bits."""
    bits = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return bits >> 23, bits & 0x7FFFFF


def _lookup(table: torch.Tensor, idx: torch.Tensor, k: torch.Tensor):
    """table[idx] (uint32 bits held in int32) times 2^(-k), where the
    scale's bits (127 - k) << 23 wrap in 32 bits as in uint32."""
    y = table[idx].view(torch.float32)
    return y * bits_f32((127 - k) << 23)


def rsqrt_emu(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Bit-exact `_mm_rsqrt_ps` for positive normal f32; table: the
    [8192] rsqrt table as int32 on x's device."""
    e, m = _split(x)
    d = e - 127
    k = d >> 1                      # arithmetic shift: floor division by 2
    p = d - 2 * k                   # exponent parity in {0, 1}
    return _lookup(table, p * 4096 + (m >> BLOCK), k)


def rcp_emu(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Bit-exact `_mm_rcp_ps` for positive normal f32; table: the
    [4096] rcp table as int32 on x's device."""
    e, m = _split(x)
    return _lookup(table, m >> BLOCK, e - 127)
