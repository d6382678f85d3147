# Frozen copy of pwnfps_tpu_torch/ops/vec.py (commit fea5a14) for the
# benchmark's plain reference.  It imports nothing of pwnfps_tpu_torch,
# pwnfps_tpu or jax; later changes to the program do not reach it.
"""Structure-of-arrays vectors over [N] tensors (pwnfps_tpu/ops/vec.py).

Same operators and association order as the JAX package, so each
expression rounds at the same places: dot products sum as
(x*x + z*z) + y*y, the SSE v_dot lane order (util.h:18-30).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class V3(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def where(self, mask, other: "V3") -> "V3":
        return V3(torch.where(mask, self.x, other.x),
                  torch.where(mask, self.y, other.y),
                  torch.where(mask, self.z, other.z))


class C4(NamedTuple):
    """Colour in reference lane order (b, g, r, a)."""

    b: torch.Tensor
    g: torch.Tensor
    r: torch.Tensor
    a: torch.Tensor

    def __add__(self, o):
        if isinstance(o, C4):
            return C4(self.b + o.b, self.g + o.g, self.r + o.r,
                      self.a + o.a)
        return C4(self.b + o, self.g + o, self.r + o, self.a + o)

    def __mul__(self, o):
        if isinstance(o, C4):
            return C4(self.b * o.b, self.g * o.g, self.r * o.r,
                      self.a * o.a)
        return C4(self.b * o, self.g * o, self.r * o, self.a * o)

    __rmul__ = __mul__

    def where(self, mask, other: "C4") -> "C4":
        return C4(torch.where(mask, self.b, other.b),
                  torch.where(mask, self.g, other.g),
                  torch.where(mask, self.r, other.r),
                  torch.where(mask, self.a, other.a))


def dot_sse(a: V3, b: V3):
    """v_dot association for w=0 vectors: (px + pz) + py."""
    return (a.x * b.x + a.z * b.z) + a.y * b.y


def normalise_sse(v: V3, rsq) -> V3:
    """v_normalise: s = (x^2 + z^2) + y^2, then the rsqrt `rsq` (the
    hardware one in fast mode, the SSE table emulation in parity)."""
    s = (v.x * v.x + v.z * v.z) + v.y * v.y
    r = rsq(s)
    return V3(v.x * r, v.y * r, v.z * r)
