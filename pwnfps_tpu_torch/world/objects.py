"""Scene-object pool and the per-frame spatial hash.
Copied from pwnfps_tpu/world/objects.py, less its native C++ rebuild.

The reference keeps a fixed pool of tagged-union "parts" and rebuilds a
per-cell bucket list of sphere pointers every frame
(level.h:1-81).  Only spheres are implemented there (CSG
types abort, level.h:34-37) and we mirror that surface.

TPU design: the pool lives on host as SoA numpy arrays (a handful of
objects mutated by game scripts each tick); `prepare_render` emits
static-shape device inputs: padded sphere SoA + a [64,64,K] bucket table
of sphere indices (-1 padded).  Bucket *insertion order* is object-index
order, which the tracer's closest-hit bookkeeping depends on
(strict '<' keeps the earliest tested sphere on ties,
trace.h:279).
"""

from __future__ import annotations

import dataclasses

import numpy as np

OBJ_MAX = 10000      # defs.h:4
T_INVAL = 0
T_FREE = 1
T_SPHERE = 2

NS_MAX = 64          # static sphere-count bound for the device arrays
K_BUCKET = 15        # static per-cell bucket capacity (4-bit packed count)


@dataclasses.dataclass
class SphereSet:
    """Static-shape device inputs describing this frame's spheres."""

    pos: np.ndarray      # [NS_MAX, 3] f32 (x, y, z)
    r: np.ndarray        # [NS_MAX] f32
    refl: np.ndarray     # [NS_MAX] f32
    col: np.ndarray      # [NS_MAX, 3] f32 (b, g, r)
    buckets: np.ndarray  # [64, 64, K_BUCKET] int32 sphere indices, -1 pad
    counts: np.ndarray   # [64, 64] int32


class ObjectPool:
    def __init__(self) -> None:
        self.typ = np.zeros(OBJ_MAX, np.int8)
        self.r = np.zeros(OBJ_MAX, np.float32)
        self.refl = np.zeros(OBJ_MAX, np.float32)
        self.pos = np.zeros((OBJ_MAX, 3), np.float32)
        self.col = np.zeros((OBJ_MAX, 3), np.float32)
        self.objs_num = 0

    # -- pool management: free-list reuse first (level.h:41-62) -------------
    def obj_new(self) -> int:
        for i in range(self.objs_num):
            if self.typ[i] == T_FREE:
                self.typ[i] = T_INVAL
                return i
        if self.objs_num >= OBJ_MAX:
            raise MemoryError("obj_new: pool exhausted")
        i = self.objs_num
        self.objs_num += 1
        self.typ[i] = T_INVAL
        return i

    def obj_free(self, i: int) -> None:
        self.typ[i] = T_FREE

    def obj_set_sphere(self, i: int, r: float, refl: float,
                       x: float, y: float, z: float,
                       b: float, g: float, rr: float) -> None:
        # float32 truncation happens at assignment, like lua_tonumber ->
        # float stores in script.h:22-32
        self.typ[i] = T_SPHERE
        self.r[i] = np.float32(r)
        self.refl[i] = np.float32(refl)
        self.pos[i] = (np.float32(x), np.float32(y), np.float32(z))
        self.col[i] = (np.float32(b), np.float32(g), np.float32(rr))

    # -- per-frame bucket rebuild (level.h:64-81) ----------------------------
    def prepare_render(self) -> SphereSet:
        n = self.objs_num
        if n > NS_MAX:
            raise ValueError(f"too many live objects for device path: {n}")
        counts = np.zeros((64, 64), np.int32)
        buckets = np.full((64, 64, K_BUCKET), -1, np.int32)
        for i in range(n):
            t = self.typ[i]
            if t == T_FREE:
                continue
            if t != T_SPHERE:
                raise ValueError(f"unsupported part type {t}")  # level.h:35
            x, _, z = self.pos[i]
            r = self.r[i]
            # C implicit float->int arg conversion truncates toward zero
            # (level.h:27-31); no bounds clamp in the reference either.
            cx1, cz1 = int(x - r), int(z - r)
            cx2, cz2 = int(x + r), int(z + r)
            # ValueError (not assert): under `python -O` asserts vanish
            # and an overflow would silently flip bit 31 of the packed
            # cell word; match the native prepare_render's error path.
            if not (0 <= cx1 and cx2 < 64 and 0 <= cz1 and cz2 < 64):
                raise ValueError(
                    f"sphere {i} bbox out of grid: the reference would "
                    "corrupt memory here")
            for cz in range(cz1, cz2 + 1):
                for cx in range(cx1, cx2 + 1):
                    k = counts[cz, cx]
                    if k >= K_BUCKET:
                        raise ValueError(
                            "bucket overflow; raise K_BUCKET")
                    buckets[cz, cx, k] = i
                    counts[cz, cx] = k + 1
        return self._soa(n, buckets, counts)

    def _soa(self, n: int, buckets: np.ndarray,
             counts: np.ndarray) -> SphereSet:
        pos = np.zeros((NS_MAX, 3), np.float32)
        rr = np.zeros(NS_MAX, np.float32)
        refl = np.zeros(NS_MAX, np.float32)
        col = np.zeros((NS_MAX, 3), np.float32)
        pos[:n] = self.pos[:n]
        rr[:n] = self.r[:n]
        refl[:n] = self.refl[:n]
        col[:n] = self.col[:n]
        return SphereSet(pos=pos, r=rr, refl=refl, col=col,
                         buckets=buckets, counts=counts)
