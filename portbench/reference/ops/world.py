# Frozen copy of pwnfps_tpu_torch/ops/world.py (commit fea5a14) for the
# benchmark's plain reference.  It imports nothing of pwnfps_tpu_torch,
# pwnfps_tpu or jax; later changes to the program do not reach it.
"""Device-resident world tables for the torch tracer and its kernel.

`world_to_torch` carries the state the JAX package builds inside
`tracer_jnp.make_env` (pwnfps_tpu/ops/tracer_jnp.py:102-203) across to
torch tensors on one device.  The cell tables hold every page of a
paged world, flattened as page*4096 + cz*64 + cx:

  * `ent`   [n_pages*4096] i32: the packed per-cell entry (a numpy copy
    of `tracer_core.decode_word`, tracer_core.py:157-170) - cls, the
    2-high wall class, has-sphere, the skip runs and the bucket count.
    A portal cell of a paged world keeps its target page in the count
    bits of its word, so its entry has the has-sphere bit and the count
    cleared, as the Pallas table builder clears the former
    (tracer_pallas.py:185-189);
  * `word`  [n_pages*4096] i32: the full channel word; portal fields
    (and a paged world's target page) are read straight from it,
    bit-equal to the JAX slot-table path (worlddev.portal_slot_tables,
    worlddev.py:396-400);
  * `sph`   [n, 16] f32: the sphere SoA plus the per-sphere scalars the
    hoisted candidate pass derives (bucket AABB, r^2, 1/r^2);
  * `bound` [4] f32: centre and radius of the sphere bounding every
    scene sphere (tracer_jnp.py:176-183);
  * parity mode's tables: `buckets` [n_pages*4096*k_bucket] i32, each
    cell's sphere indices in insertion order (-1 pad; the JAX package's
    [n_pages*4096 * 15] table cut to the k_bucket slots the scan reads),
    and the SSE `rsqrt_tab` [8192] and `rcp_tab` [4096] (uint32 bits held
    in i32), which the plain tracer reads, and their compact form `sse`
    [4096] i16 (`core.approx.compact_tables`, 8 KB), which the CUDA
    kernel reads in their place.  The scan reads each sphere's centre and
    radius from `sph`.

`world_to_torch` takes a numpy `WorldDev` and `WorldMeta` of either
package (the same fields), one page or a paged atlas
(worlddev.build_world_paged).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.approx import compact_tables
from . import worlddev as W

# sph table columns
SX, SY, SZ, SR, SREFL, SCB, SCG, SCR = range(8)
SBX1, SBX2, SBZ1, SBZ2, SRAD2, SINVR2 = range(8, 14)
SPH_COLS = 16
NSPH_MAX = 64          # sphere capacity: world/objects.py NS_MAX, as the
                       # JAX package's jnp backend traces them


def decode_word_np(w: np.ndarray, paged: bool = False) -> np.ndarray:
    """tracer_core.decode_word on numpy: the compact cell entry.  paged:
    portal cells' nsph bits hold their target page, not a count, so the
    entry takes 0 for it."""
    cls = W.w_cls(w)
    not_p = cls != W.PORTAL
    nsph = W.w_nsph(w)
    if paged:
        nsph = np.where(not_p, nsph, 0)
    xcls = W.w_xcls(w)
    xc2 = np.where((xcls == W.TALL) | (xcls == W.TALLFOG), 1,
                   np.where(xcls == W.LOWER, 2, 0))
    ent = (cls | (xc2 << 4)
           | (np.where(nsph > 0, 1, 0) << 6)
           | (np.where(not_p, W.w_runx(w), 0) << 7)
           | (np.where(not_p, W.w_runz(w), 0) << 11)
           | (nsph << 15))
    return ent.astype(np.int32)


def sphere_table(world: W.WorldDev, n: int) -> np.ndarray:
    """[n, 16] f32 sphere records.  The derived columns are the scalar
    terms make_sphere_all computes per sphere (tracer_core.py:403-426),
    in the same float32 operations."""
    f = np.float32
    t = np.zeros((n, SPH_COLS), np.float32)
    for i in range(n):
        x, y, z = (f(v) for v in world.sph_pos[i])
        r = f(world.sph_r[i])
        t[i, SX:SZ + 1] = (x, y, z)
        t[i, SR] = r
        t[i, SREFL] = world.sph_refl[i]
        t[i, SCB:SCR + 1] = world.sph_col[i]
        t[i, SBX1] = f(np.int32(x - r))
        t[i, SBX2] = f(np.int32(x + r)) + f(1.0)
        t[i, SBZ1] = f(np.int32(z - r))
        t[i, SBZ2] = f(np.int32(z + r)) + f(1.0)
        rad2 = r * r
        t[i, SRAD2] = rad2
        t[i, SINVR2] = f(1.0) / max(rad2, f(1e-30))
    return t


def sphere_bound(world: W.WorldDev, n: int) -> np.ndarray:
    """Bounding sphere of the first n spheres (tracer_jnp.get_bound)."""
    if n == 0:
        return np.zeros(4, np.float32)
    c = np.asarray(world.sph_pos[:n], np.float32)
    ctr = (c.min(axis=0) + c.max(axis=0)) * np.float32(0.5)
    d = c - ctr[None, :]
    d2 = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
    rad = np.sqrt(d2).max() + np.asarray(world.sph_r[:n], np.float32).max()
    return np.array([ctr[0], ctr[1], ctr[2], rad], np.float32)


@dataclasses.dataclass(frozen=True)
class TorchWorld:
    ent: torch.Tensor       # [n_pages*4096] i32 compact cell entries
    word: torch.Tensor      # [n_pages*4096] i32 full channel words
    sph: torch.Tensor       # [n, 16] f32 sphere records
    bound: torch.Tensor     # [4] f32 bound centre + radius
    buckets: torch.Tensor   # [n_pages*4096*k_bucket] i32 sphere ids
    rsqrt_tab: torch.Tensor  # [8192] i32 (uint32 bits)
    rcp_tab: torch.Tensor   # [4096] i32 (uint32 bits)
    sse: torch.Tensor       # [4096] i16 the two tables' compact form
    n_spheres: int
    k_bucket: int           # bucket slots the parity scan reads
    skip_ok: bool           # meta.has_clear: may the empty-space skip run
    slack: float            # meta.sph_slack: bound-gate slack
    n_pages: int            # pages of the atlas (1: one 64x64 grid)
    sphere_page: int        # the page every sphere lives on
    # host copies of sph/bound as Python floats (f32-exact): the plain
    # tracer's per-sphere scalars
    sph_host: tuple
    bound_host: tuple

    @property
    def device(self) -> torch.device:
        return self.ent.device


def _i32(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy()
                            ).to(device)


def world_to_torch(world: W.WorldDev, meta: W.WorldMeta,
                   device) -> TorchWorld:
    pages = int(meta.n_pages)
    n = int(meta.n_spheres)
    if n > NSPH_MAX:
        raise ValueError(f"{n} spheres exceed the {NSPH_MAX}-sphere cap")
    word = np.asarray(world.word, np.int32)
    if not 1 <= pages <= 16 or word.shape != (pages * 4096,) \
            or not 0 <= meta.sphere_page < pages:
        raise ValueError(f"word table {word.shape} does not hold "
                         f"{pages} pages of 4096 cells with spheres on "
                         f"page {meta.sphere_page}")
    kb = int(meta.k_bucket)
    buckets = np.asarray(world.buckets, np.int32).reshape(pages * 4096,
                                                          -1)
    if kb > buckets.shape[1] or (kb > 0 and buckets[:, :kb].max() >= n):
        raise ValueError(f"bucket table does not fit k_bucket={kb} and "
                         f"{n} spheres")
    sph = sphere_table(world, n)
    bound = sphere_bound(world, n)
    rsqrt_tab = np.asarray(world.rsqrt_tab, np.uint32)
    rcp_tab = np.asarray(world.rcp_tab, np.uint32)
    sse = compact_tables(rsqrt_tab, rcp_tab)
    return TorchWorld(
        ent=_i32(decode_word_np(word, pages > 1), device),
        word=_i32(word, device),
        sph=torch.from_numpy(sph).to(device),
        bound=torch.from_numpy(bound).to(device),
        buckets=_i32(buckets[:, :kb].reshape(-1), device),
        rsqrt_tab=_i32(rsqrt_tab, device),
        rcp_tab=_i32(rcp_tab, device),
        sse=torch.from_numpy(sse.view(np.int16).copy()).to(device),
        n_spheres=n, k_bucket=kb, skip_ok=bool(meta.has_clear),
        slack=float(meta.sph_slack), n_pages=pages,
        sphere_page=int(meta.sphere_page),
        sph_host=tuple(tuple(float(v) for v in row) for row in sph),
        bound_host=tuple(float(v) for v in bound))
