"""The wavefront tracer's semantics in plain torch.

A port of pwnfps_tpu/ops/tracer_core.py over [N] tensors: the same DDA
march, ramps, fog, 2-high walls, quarter-turn portals, shading, the
reflect jitter and the backward unwind blend, each expression in the JAX
package's order so that it rounds at the same places.  This is the plain
version the CPU tests hold against the JAX package and against which the
CUDA kernel (csrc/tracer.cu) is held on the card.

Paged worlds (worlddev.build_world_paged): every lane carries its page,
each cell fetch reads page*4096 + its clamped local index, a portal
moves the lane to the target page its word holds (bits 26-29), spheres
exist only on `sphere_page`, and each bounce wave starts on the page
where the wave before it ended.  A one-page world is the degenerate case
(every page 0).  Paged worlds run in fast mode only.

Two modes, as in the JAX package, selected by `cfg.parity`:

  * fast: the hardware rsqrt/div/sqrt/sin/cos/exp, the empty-space
    skip, and sphere candidates hoisted out of the DDA loop per ray
    line (`sphere_all`);
  * parity: the bit-exact math of `Math` (SSE-table rsqrt/rcp,
    integer-exact div/sqrt, the pinned libm), unit steps, and the
    reference's cell-driven sphere-bucket scan (`sphere_pass`).  On
    every device this gives the bits of ops/tracer_ref.ScalarTracer
    (pinned=True), since eager torch neither contracts FMAs nor
    reassociates.

What differs from the JAX module, none of it visible in the bits:

  * `lax.while_loop` is a Python loop that runs while any lane is
    active and the step budget lasts.  Dead lanes are frozen, so the
    loop works on the active lanes only, compacting them as they die.
  * Each `lax.cond` exists because TPU lanes share control flow; its
    bodies are per-lane masked, so here each runs when some lane needs
    it and is masked the same way.  The whole-tile `anyq` gate of the
    hoisted sphere pass is dropped: the full pass runs on every lane in
    its mask, as the jnp backend does over a whole frame.
  * The small-integer packing of the carry and of the event-cond
    outputs (`_pack_carry`, `pw`, `ccf`) is the identity on bits and is
    not reproduced.
  * Float-to-int conversions saturate as XLA's and CUDA's do (`to_i32`).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from ..core import detmath, lcg
from ..core.approx import rcp_emu, rsqrt_emu
from ..core.config import (COL_CEIL, COL_FLOOR, COL_MAGENTA, COL_WALL,
                           EPSILON, FXN, FXP, FYN, FYP, FZN, FZP,
                           RenderConfig)
from ..core.ieee import div_rn, sqrt_rn, to_i32
from . import worlddev as W
from .vec import C4, V3, dot_sse, normalise_sse
from .world import (SBX1, SBX2, SBZ1, SBZ2, SCB, SCG, SCR, SINVR2, SR,
                    SRAD2, SREFL, SX, SY, SZ, TorchWorld)

F32 = torch.float32
I32 = torch.int32

# terminal kinds (0: none)
T_WALL, T_SPHERE, T_SKY = 1, 2, 3
# wall colour ids
C_CEIL, C_FLOOR, C_WALL, C_MAGENTA = 0, 1, 2, 3
PAL = np.array([COL_CEIL, COL_FLOOR, COL_WALL, COL_MAGENTA], np.float32)

_FIRE_NONE = float(np.float32(3.0e38))
_EPS = float(np.float32(EPSILON))
_PI_HALF = float(np.float32(np.pi) * np.float32(0.5))
_PI_TWO = float(np.float32(np.pi) * np.float32(2.0))

# class bitsets (tracer_core's clsbit probes)
_FLOORISH = (1 << W.FLOOR) | (1 << W.FOG) | (1 << W.LOWER)
_TALL = (1 << W.TALL) | (1 << W.TALLFOG)
_RAMP = (1 << (W.RAMP_CR + 1)) - (1 << W.RAMP_GT)
_FOGC = (1 << W.FOG) | (1 << W.TALLFOG)


class Math(NamedTuple):
    """Float-semantics bundle (tracer_core.Math): fast mode plugs the
    hardware ops, parity mode the bit-exact emulations."""

    rsq: Any
    rcp: Any
    div: Any
    sqrt: Any
    sin: Any
    cos: Any
    exp: Any


FAST_MATH = Math(rsq=torch.rsqrt, rcp=lambda x: 1.0 / x,
                 div=lambda a, b: a / b, sqrt=torch.sqrt, sin=torch.sin,
                 cos=torch.cos, exp=torch.exp)


def make_math(wt: TorchWorld, parity: bool) -> Math:
    """tracer_jnp.make_math: the parity bundle reads the world's SSE
    tables."""
    if not parity:
        return FAST_MATH
    return Math(rsq=lambda x: rsqrt_emu(x, wt.rsqrt_tab),
                rcp=lambda x: rcp_emu(x, wt.rcp_tab),
                div=div_rn, sqrt=sqrt_rn, sin=detmath.sin_det,
                cos=detmath.cos_det, exp=detmath.exp_det)


def _bit(bits: int, c: torch.Tensor) -> torch.Tensor:
    """(bits >> c) & 1 as a bool mask."""
    return ((bits >> c) & 1) != 0


def _max(a, b):
    """jnp.maximum: NaN-propagating."""
    return torch.maximum(a, b) if isinstance(b, torch.Tensor) else \
        torch.clamp_min(a, b)


class SegState(NamedTuple):
    pos: V3
    ray: V3
    iavel: V3
    wdist: V3
    ent: torch.Tensor         # packed entry of the current cell
    gx: torch.Tensor
    gy: torch.Tensor
    gz: torch.Tensor
    cx: torch.Tensor
    cz: torch.Tensor
    page: torch.Tensor        # i32 page of the lane (0 in a one-page world)
    cdist: torch.Tensor
    fog: torch.Tensor
    ldir: torch.Tensor
    active: torch.Tensor      # bool
    aux_dist: torch.Tensor
    aux_t0: torch.Tensor
    sph_dirty: torch.Tensor
    aux_apos: V3
    aux_idx: torch.Tensor
    aux_diff: torch.Tensor
    tmeta: torch.Tensor       # terminal kind | colour id << 2


class SegOut(NamedTuple):
    tkind: torch.Tensor
    tldir: torch.Tensor
    tcolid: torch.Tensor
    tfog: torch.Tensor
    tdist: torch.Tensor
    tpos: V3
    tray: V3
    tpage: torch.Tensor       # page the segment ended on
    aux_refl: torch.Tensor
    aux_pos: V3
    aux_norm: V3
    aux_col: C4


def _tmap(fn, t):
    """Apply fn to every tensor leaf of a (nested) NamedTuple."""
    if isinstance(t, tuple):
        return type(t)(*(_tmap(fn, v) for v in t))
    return fn(t)


def _tmap2(fn, a, b):
    if isinstance(a, tuple):
        return type(a)(*(_tmap2(fn, x, y) for x, y in zip(a, b)))
    return fn(a, b)


# ---- cell fetches ----------------------------------------------------------

def flat_cell_index(cx, cz, page):
    """tracer_core.flat_cell_index: an out-of-bounds cell reads cell 0
    of the lane's page."""
    inb = (cx >= 0) & (cx < 64) & (cz >= 0) & (cz < 64)
    return torch.where(inb, cz * 64 + cx, 0) + page * 4096


def fetch(wt: TorchWorld, cx, cz, page):
    return wt.ent[flat_cell_index(cx, cz, page).long()]


def fetch_portal(wt: TorchWorld, cx, cz, page):
    """(pkind, prot, pdcx, pdcz, dpage) of each lane's cell; dpage is
    the lane's own page in a one-page world, whose bits 26-29 count
    spheres."""
    w = wt.word[flat_cell_index(cx, cz, page).long()]
    dpage = W.w_dpage(w) if wt.n_pages > 1 else page
    return (W.w_pkind(w), W.w_prot(w), W.w_pdcx(w), W.w_pdcz(w), dpage)


# ---- hoisted sphere candidates (tracer_core.make_sphere_all) --------------

def sphere_rel(wt: TorchWorld, px, pz, vx, vz, page):
    """XZ line vs the bounding circle, on the sphere page only
    (tracer_core.make_sphere_rel)."""
    bx, _, bz, br = wt.bound_host
    brq2 = float(np.float32(np.float32(br) * np.float32(br))
                 + np.float32(wt.slack))
    rx = bx - px
    rz = bz - pz
    d2xz = rx * rx + rz * rz
    dtxz = rx * vx + rz * vz
    l2 = vx * vx + vz * vz
    return ((d2xz - brq2) * l2 < dtxz * dtxz) & (page == wt.sphere_page)


def sphere_all(wt: TorchWorld, s: SegState, mask, merge: bool,
               math: Math):
    """Fast mode: candidate pass of every sphere against each lane's
    current line, evaluated at the AABB entry point
    (tracer_core.py:298-534).
    Returns (aux_dist, aux_apos, aux_idx, aux_diff, aux_t0, rel_bit)."""
    aux_dist = s.aux_dist
    zero = torch.zeros_like(s.pos.x)
    if merge:
        pend = aux_dist != -1.0
        fire = torch.where(pend, _max(aux_dist, s.aux_t0), _FIRE_NONE)
        best_aux = torch.where(pend, aux_dist, _FIRE_NONE)
    else:
        fire = zero + _FIRE_NONE
        best_aux = zero + _FIRE_NONE
    new = torch.zeros_like(mask)
    w_te = zero
    w_sd = zero
    w_idx = torch.zeros_like(s.sph_dirty)
    base = mask & s.active & (s.page == wt.sphere_page)
    sxp = s.ray.x >= 0.0
    szp = s.ray.z >= 0.0
    ivx_s = torch.where(sxp, s.iavel.x, -s.iavel.x)
    ivz_s = torch.where(szp, s.iavel.z, -s.iavel.z)
    for si in range(wt.n_spheres):
        r = wt.sph_host[si]
        tx = (torch.where(sxp, r[SBX1], r[SBX2]) - s.pos.x) * ivx_s
        tz = (torch.where(szp, r[SBZ1], r[SBZ2]) - s.pos.z) * ivz_s
        t_entry = _max(_max(tx, tz), 0.0)
        pent = s.pos + s.ray * t_entry
        rel = V3(r[SX] - pent.x, r[SY] - pent.y, r[SZ] - pent.z)
        dist2 = dot_sse(rel, rel)
        dot = dot_sse(rel, s.ray)
        calcrad2 = dist2 - dot * dot
        sph_dist = math.sqrt(dist2) - math.sqrt(
            _max(1.0 - calcrad2 * r[SINVR2], 0.0))
        te_d = s.cdist + t_entry
        aux_c = sph_dist + te_d
        fire_c = _max(aux_c, te_d)
        upd = (base & (dot > 0.0) & (calcrad2 < r[SRAD2])
               & ((fire_c < fire) | ((fire_c == fire) & (aux_c < best_aux))))
        fire = torch.where(upd, fire_c, fire)
        best_aux = torch.where(upd, aux_c, best_aux)
        new = new | upd
        w_te = torch.where(upd, t_entry, w_te)
        w_sd = torch.where(upd, sph_dist, w_sd)
        w_idx = torch.where(upd, si, w_idx)
    aux_dist = torch.where(new, best_aux, aux_dist)
    w_pos = V3(*(wt.sph[:, c][w_idx.long()] for c in (SX, SY, SZ)))
    w_t0 = s.cdist + w_te
    w_from = s.pos + s.ray * w_te
    apos = w_from + s.ray * w_sd
    anorm = normalise_sse(apos - w_pos, math.rsq)
    diff = _max(-dot_sse(s.ray, anorm), 0.0)
    diff = 0.2 + 0.8 * diff
    rel_bit = torch.where(sphere_rel(wt, s.pos.x, s.pos.z, s.ray.x,
                                     s.ray.z, s.page), 2, 0).to(I32)
    return (aux_dist,
            apos.where(new, s.aux_apos),
            torch.where(new, w_idx, s.aux_idx),
            torch.where(new, diff, s.aux_diff),
            torch.where(new, w_t0, s.aux_t0),
            rel_bit)


def _apply_aux(s: SegState, aux) -> SegState:
    return s._replace(aux_dist=aux[0], aux_apos=aux[1], aux_idx=aux[2],
                      aux_diff=aux[3], aux_t0=aux[4], sph_dirty=aux[5])


def sphere_pass(wt: TorchWorld, s: SegState, math: Math,
                counts: dict | None = None) -> SegState:
    """Parity mode: the reference's per-cell sphere tests
    (trace.h:252-296, tracer_jnp._sphere_pass).  Each active lane
    standing in a bucketed cell tests the cell's bucket slots k = 0 ..
    k_bucket-1 in order; a slot is valid when k < the cell's count and
    it holds a sphere, and the last strictly closer hit wins (the
    reference's insertion-order tie-break).  The winner's hit point and
    diffuse factor are shaded once, from its exact inputs.

    The per-(lane, slot) arithmetic runs batched over [lanes, slots]
    (elementwise, so the same bits as slot by slot); only the ordered
    winner selection loops over the slots."""
    kb = wt.k_bucket
    inb = (s.cx >= 0) & (s.cx < 64) & (s.cz >= 0) & (s.cz < 64)
    scan = s.active & inb & (((s.ent >> 15) & 0x1F) > 0)
    if kb == 0 or not bool(scan.any()):
        return s
    lanes = torch.nonzero(scan).flatten()
    cidx = (s.cz[lanes] * 64 + s.cx[lanes]).long()
    nsph = ((s.ent[lanes] >> 15) & 0x1F)[:, None]
    si = wt.buckets.view(4096, kb)[cidx]                     # [m, kb]
    slot = torch.arange(kb, dtype=I32, device=si.device)[None, :]
    valid = (slot < nsph) & (si >= 0)
    si = si.clamp(0, wt.n_spheres - 1)
    sil = si.long()
    pos = V3(*(c[lanes][:, None] for c in s.pos))
    ray = V3(*(c[lanes][:, None] for c in s.ray))
    spos = V3(*(wt.sph[:, c][sil] for c in (SX, SY, SZ)))
    sr = wt.sph[:, SR][sil]
    rad2 = sr * sr
    rel = spos - pos
    dist2 = dot_sse(rel, rel)
    dot = dot_sse(rel, ray)
    calcrad2 = dist2 - dot * dot
    sph_dist = math.sqrt(dist2) - math.sqrt(_max(
        1.0 - math.div(calcrad2, torch.where(rad2 > 0, rad2, 1.0)), 0.0))
    hit = valid & (dot > 0.0) & (calcrad2 < rad2)
    if counts is not None:
        counts["slot_tests"] += int(valid.sum())
        counts["slot_hits"] += int(hit.sum())
    cdist = s.cdist[lanes]
    aux = s.aux_dist[lanes]
    new = torch.zeros_like(cdist, dtype=torch.bool)
    w_sd = torch.zeros_like(cdist)
    w_idx = torch.zeros_like(s.aux_idx[lanes])
    for k in range(kb):
        cand = sph_dist[:, k] + cdist
        upd = hit[:, k] & ((aux == -1.0) | (cand < aux))
        aux = torch.where(upd, cand, aux)
        new = new | upd
        w_sd = torch.where(upd, sph_dist[:, k], w_sd)
        w_idx = torch.where(upd, si[:, k], w_idx)
    pos = V3(*(c[:, 0] for c in pos))
    ray = V3(*(c[:, 0] for c in ray))
    w_pos = V3(*(wt.sph[:, c][w_idx.long()] for c in (SX, SY, SZ)))
    apos = pos + ray * w_sd
    anorm = normalise_sse(apos - w_pos, math.rsq)
    diff = _max(-dot_sse(ray, anorm), 0.0)
    diff = 0.2 + 0.8 * diff
    old = V3(*(c[lanes] for c in s.aux_apos))
    apos = apos.where(new, old)

    def put(full, part):
        return full.index_copy(0, lanes, part)

    return s._replace(
        aux_dist=put(s.aux_dist, aux),
        aux_apos=V3(*(put(f, p) for f, p in zip(s.aux_apos, apos))),
        aux_idx=put(s.aux_idx, torch.where(new, w_idx, s.aux_idx[lanes])),
        aux_diff=put(s.aux_diff, torch.where(new, diff,
                                             s.aux_diff[lanes])))


def sphere_view(wt: TorchWorld, s: SegState, math: Math):
    """Winner rematerialization (tracer_core.make_sphere_view)."""
    zero = torch.zeros_like(s.aux_diff)
    one = torch.ones_like(zero)
    if wt.n_spheres == 0:
        return zero + 0.25, s.aux_apos, V3(zero, zero, zero), \
            C4(one, one, one, one)
    valid = s.aux_dist != -1.0
    idx = s.aux_idx.long()
    w_pos = V3(*(wt.sph[:, c][idx] for c in (SX, SY, SZ)))
    w_refl = wt.sph[:, SREFL][idx]
    anorm = normalise_sse(s.aux_apos - w_pos, math.rsq)
    refl = torch.where(valid, w_refl, 0.25)
    norm = anorm.where(valid, V3(zero, zero, zero))
    col = C4(*(torch.where(valid, s.aux_diff * wt.sph[:, c][idx], one)
               for c in (SCB, SCG, SCR)), torch.where(valid, zero, one))
    return refl, s.aux_apos, norm, col


# ---- segment init ----------------------------------------------------------

def _init_march(wt: TorchWorld, ifrom: V3, iray: V3, math: Math, page):
    """trace_ray's prologue (tracer_core._init_march)."""
    ray = normalise_sse(iray, math.rsq)

    def clamp(c):
        return torch.where((c > -_EPS) & (c < _EPS),
                           torch.where(c < 0.0, -_EPS, _EPS), c)

    ray = V3(clamp(ray.x), clamp(ray.y), clamp(ray.z))
    cx = to_i32(ifrom.x)
    cz = to_i32(ifrom.z)
    one = torch.ones_like(cx)
    gx = torch.where(iray.x < 0.0, -one, one)
    gy = torch.where(iray.y < 0.0, -one, one)
    gz = torch.where(iray.z < 0.0, -one, one)
    iavel = V3(math.rcp(torch.abs(ray.x)), math.rcp(torch.abs(ray.y)),
               math.rcp(torch.abs(ray.z)))
    wd = V3(ifrom.x - cx.to(F32), ifrom.y, ifrom.z - cz.to(F32))

    def flip(w, c):
        return torch.where(c >= 0.0, 1.0 - w, w)

    wdist = V3(flip(wd.x, ray.x) * iavel.x, flip(wd.y, ray.y) * iavel.y,
               flip(wd.z, ray.z) * iavel.z)
    return ray, cx, cz, gx, gy, gz, iavel, wdist, fetch(wt, cx, cz, page)


def init_segment(wt: TorchWorld, ifrom: V3, iray: V3, active,
                 math: Math, page) -> SegState:
    (ray, cx, cz, gx, gy, gz, iavel, wdist, ent) = _init_march(
        wt, ifrom, iray, math, page)
    z1 = torch.zeros_like(ifrom.x)
    zi = torch.zeros_like(cx)
    return SegState(
        pos=ifrom, ray=ray, iavel=iavel, wdist=wdist, ent=ent,
        gx=gx, gy=gy, gz=gz, cx=cx, cz=cz, page=page,
        cdist=z1, fog=z1, ldir=zi + FYN, active=active.clone(),
        aux_dist=z1 - 1.0, aux_t0=z1 - 1.0, sph_dirty=zi,
        aux_apos=V3(z1, z1, z1), aux_idx=zi, aux_diff=z1, tmeta=zi)


# ---- one DDA step ----------------------------------------------------------

def _portal_calc(wt: TorchWorld, s: SegState):
    """Portal traversal targets of each lane's current cell
    (tracer_core.portal_calc), unpacked."""
    pkind, prot, pdcx, pdcz, dpage = fetch_portal(wt, s.cx, s.cz, s.page)
    cxp = s.cx + pdcx
    czp = s.cz + pdcz
    px_t = s.pos.x + pdcx.to(F32)
    pz_t = s.pos.z + pdcz.to(F32)
    ldir_p = (s.ldir - prot) & 3
    cxh = cxp.to(F32) + 0.5
    czh = czp.to(F32) + 0.5
    trx, trz = px_t, pz_t
    tvx, tvz = s.ray.x, s.ray.z
    r1, r2, r3 = prot == 1, prot == 2, prot == 3
    W_ = torch.where
    px_r = W_(r1, cxh + (trz - czh),
              W_(r2, cxh * 2.0 - px_t, W_(r3, cxh - (trz - czh), px_t)))
    pz_r = W_(r1, czh - (trx - cxh),
              W_(r2, czh * 2.0 - pz_t, W_(r3, czh + (trx - cxh), pz_t)))
    vx_r = W_(r1, tvz, W_(r2, -tvx, W_(r3, -tvz, tvx)))
    vz_r = W_(r1, -tvx, W_(r2, -tvz, W_(r3, tvx, tvz)))
    gx_r = W_(r1, s.gz, W_(r2, -s.gx, W_(r3, -s.gz, s.gx)))
    gz_r = W_(r1, -s.gx, W_(r2, -s.gz, W_(r3, s.gx, s.gz)))
    swap = r1 | r3
    wx_r = W_(swap, s.wdist.z, s.wdist.x)
    wz_r = W_(swap, s.wdist.x, s.wdist.z)
    ix_r = W_(swap, s.iavel.z, s.iavel.x)
    iz_r = W_(swap, s.iavel.x, s.iavel.z)
    step_dx = W_(ldir_p == FZP, 0, W_(ldir_p == FXN, -1,
                                      W_(ldir_p == FZN, 0, 1)))
    step_dz = W_(ldir_p == FZP, 1, W_(ldir_p == FZN, -1, 0))
    return dict(pkind=pkind, dpage=dpage, ldir_p=ldir_p, gx_r=gx_r,
                gz_r=gz_r,
                cx_f=cxp + step_dx, cz_f=czp + step_dz,
                px_f=px_r + step_dx.to(F32), pz_f=pz_r + step_dz.to(F32),
                vx_r=vx_r, vz_r=vz_r, wx_r=wx_r, wz_r=wz_r,
                ix_r=ix_r, iz_r=iz_r)


def _ramp_calc(s: SegState, cls, math: Math):
    """Ramp tilt + tilted-ray wdist.y (tracer_core.ramp_calc).  tilt is
    exactly +-0 on non-ramp lanes (zero coefficients)."""
    W_ = torch.where
    coef_x = W_(cls == W.RAMP_GT, -0.5, W_(cls == W.RAMP_LT, 0.5, 0.0))
    coef_z = W_(cls == W.RAMP_CM, -0.5, W_(cls == W.RAMP_CR, 0.5, 0.0))
    rampx = (cls == W.RAMP_GT) | (cls == W.RAMP_LT)
    rampc = (cls >= W.RAMP_GT) & (cls <= W.RAMP_CR)
    tilt = W_(rampx, coef_x * s.ray.x, coef_z * s.ray.z)
    ry2 = W_(rampc, s.ray.y + tilt, s.ray.y)
    ay2 = W_(ry2 < 0.0, -ry2, ry2)
    wyr = W_(ry2 >= 0.0, 1.0 - s.pos.y, s.pos.y) * math.div(
        torch.ones_like(ay2), ay2)
    return tilt, wyr


def segment_body(wt: TorchWorld, s: SegState, use_skip: bool,
                 hoisted: bool, math: Math,
                 counts: dict | None = None) -> SegState:
    """One DDA step for every lane (tracer_core.segment_body, one page).
    hoisted: fast mode's per-line sphere candidates (else parity mode's
    cell-driven bucket scan).  Dead lanes come out unchanged in every
    field a later stage reads."""
    W_ = torch.where
    cls = s.ent & 0xF

    # ---- rare events: sphere refresh or scan, portal targets, ramp ----
    if not hoisted:
        s = sphere_pass(wt, s, math, counts)
    else:
        refresh = (s.sph_dirty & 1) != 0
        if bool((refresh & s.active).any()):
            a6 = sphere_all(wt, s, refresh, merge=True, math=math)
            s = s._replace(aux_dist=a6[0], aux_apos=a6[1], aux_idx=a6[2],
                           aux_diff=a6[3], aux_t0=a6[4],
                           sph_dirty=W_(refresh, a6[5], s.sph_dirty))
    is_portal = cls == W.PORTAL
    if bool((is_portal & s.active).any()):
        p = _portal_calc(wt, s)
    else:
        p = None
    tilt, wy_ramp = _ramp_calc(s, cls, math)

    is_floorish = _bit(_FLOORISH, cls)
    is_tall = _bit(_TALL, cls)
    is_ramp = _bit(_RAMP, cls)
    is_wall = cls == W.WALL
    is_fogc = _bit(_FOGC, cls)
    has_aux = s.aux_dist != -1.0
    fire = _max(s.aux_dist, s.aux_t0) if hoisted else s.aux_dist

    pos, ray, wdist, iavel = s.pos, s.ray, s.wdist, s.iavel
    gx, gy, gz = s.gx, s.gy, s.gz

    ray_y2 = ray.y + tilt
    ray2 = V3(ray.x, ray_y2, ray.z)

    # ---- empty-space skip ----
    wx, wy0, wz = wdist.x, wdist.y, wdist.z
    if use_skip:
        runx = (s.ent >> 7) & 0xF
        runz = (s.ent >> 11) & 0xF
        ax = torch.abs(ray.x)
        az = torch.abs(ray.z)
        jx = to_i32(torch.floor((wz - wx) * ax))
        jz = to_i32(torch.floor((wx - wz) * az))
        kx = torch.clamp(torch.minimum(runx, jx), 0, 15)
        kz = torch.clamp(torch.minimum(runz, jz), 0, 15)
        wxe = wx + kx.to(F32) * iavel.x
        wze = wz + kz.to(F32) * iavel.z
    else:
        wxe, wze = wx, wz

    wy_tall = W_(gy > 0, wy0 + iavel.y, wy0)
    wy = W_(is_tall, wy_tall, W_(is_ramp, wy_ramp, wy0))

    # ---- ramps: sphere exit before stepping ----
    a = s.active
    sgt = s.cdist > fire
    m_presph = a & is_ramp & has_aux & sgt
    a = a & ~m_presph

    # ---- min-axis crossing ----
    ymin = (wy < wxe) & (wy < wze)
    xmin = ~ymin & (wxe < wze)
    zmin = ~(ymin | xmin)
    t = W_(ymin, wy, W_(xmin, wxe, wze))
    gsel = W_(is_ramp, gy, gx)
    ldir_t = W_(ymin, W_(gy < 0, FYN, FYP),
                W_(xmin, W_(gsel < 0, FXN, FXP), W_(gz < 0, FZN, FZP)))
    marchable = is_floorish | is_tall | is_ramp
    cdist2 = s.cdist + t
    pos2 = pos + ray2 * t
    ldir2 = ldir_t

    # ---- floor/tall: fog + sphere exit + Y hit ----
    ft = a & (is_floorish | is_tall)
    m_sph2 = ft & has_aux & (cdist2 > fire)
    extra = W_(is_fogc & (s.aux_dist > s.cdist), s.aux_dist - s.cdist, 0.0)
    a = a & ~m_sph2
    ft = a & (is_floorish | is_tall)
    fog2 = W_(ft & is_fogc, s.fog + (cdist2 - s.cdist), s.fog)
    isY2 = (ldir2 == FYN) | (ldir2 == FYP)
    m_yhit = ft & isY2
    a = a & ~m_yhit

    # ---- ramp Y hit ----
    ramp_go = a & is_ramp
    m_ryhit = ramp_go & isY2
    a = a & ~m_ryhit

    # ---- X/Z continuation ----
    cont = a & marchable
    xstep = cont & xmin
    zstep = cont & zmin
    stepped = xstep | zstep
    sub = W_(xstep, wxe, wze)
    wnx = W_(xstep, iavel.x, wx - sub)
    wny = wy - sub
    wnz = W_(zstep, iavel.z, wz - sub)
    wny = W_(stepped & is_tall & (gy > 0), wny - iavel.y, wny)
    if use_skip:
        cx2 = s.cx + W_(xstep, gx * (1 + kx), 0)
        cz2 = s.cz + W_(zstep, gz * (1 + kz), 0)
    else:
        cx2 = s.cx + W_(xstep, gx, 0)
        cz2 = s.cz + W_(zstep, gz, 0)

    ldir3 = W_(ramp_go & xstep, W_(ray2.x < 0.0, FXN, FXP),
               W_(ramp_go & zstep, W_(ray2.z < 0.0, FZN, FZP), ldir2))
    rgs = ramp_go & stepped
    ray_y3 = W_(rgs, ray_y2 - tilt, ray_y2)
    ray3 = V3(ray2.x, ray_y3, ray2.z)
    wy_post = W_(ray_y3 >= 0.0, 1.0 - pos2.y, pos2.y) * iavel.y
    wny = W_(rgs, wy_post, wny)

    # ---- portal traversal (targets from the rare-event branch above;
    # with no active portal lane, pkind == 0 and no lane takes them) ----
    if p is None:
        p = dict(pkind=torch.zeros_like(s.cx), dpage=s.page,
                 ldir_p=s.ldir, gx_r=gx, gz_r=gz, cx_f=s.cx, cz_f=s.cz,
                 px_f=pos.x, pz_f=pos.z, vx_r=ray.x, vz_r=ray.z, wx_r=wx,
                 wz_r=wz,
                 ix_r=iavel.x, iz_r=iavel.z)
        nr = None
    elif hoisted:
        # post-portal line relevance (the event branch's bit 22)
        nr = sphere_rel(wt, p["px_f"], p["pz_f"], p["vx_r"], p["vz_r"],
                        p["dpage"])
    pkind = p["pkind"]
    pgo = a & is_portal & (pkind == 1)
    cx_f, cz_f = p["cx_f"], p["cz_f"]

    # ---- the one per-step fetch ----
    tgt_cx = W_(pgo, cx_f, cx2)
    tgt_cz = W_(pgo, cz_f, cz2)
    tgt_pg = W_(pgo, p["dpage"], s.page)
    f_next = fetch(wt, tgt_cx, tgt_cz, tgt_pg)

    # ---- transitions ----
    ncls = f_next & 0xF
    n_tall = _bit(_TALL, ncls)
    n_lower = ncls == W.LOWER
    pos3y = pos2.y
    tr1 = stepped & (cls == W.LOWER) & n_tall
    pos3y = W_(tr1, pos3y + 1.0, pos3y)
    wny = W_(tr1, W_(gy < 0, wny + iavel.y, wny - iavel.y), wny)
    tr2 = stepped & is_tall & n_lower
    pos3y = W_(tr2, pos3y - 1.0, pos3y)
    wny = W_(tr2, W_(gy > 0, wny + iavel.y, wny - iavel.y), wny)

    # ---- 2-high wall check ----
    xc = (f_next >> 4) & 3
    y_out = (pos3y < 0.0) | (pos3y > 1.0)
    chk = stepped & is_tall & y_out
    revert = chk & (xc == 2)
    pos3y = W_(revert, pos3y + 1.0, pos3y)
    wny = W_(revert, W_(gy > 0, wny - iavel.y, wny + iavel.y), wny)
    pos3 = V3(pos2.x, pos3y, pos2.z)
    m_wall2 = chk & (xc != 1)
    a = a & ~m_wall2

    # ---- portal cells + plain wall ----
    p_bad = a & is_portal & (pkind == 2)
    p_wrong = a & is_portal & (pkind == 3)
    wall0 = a & is_wall
    sphfire = has_aux & sgt
    nsf = ~sphfire
    m_pbs = p_bad & sphfire
    m_pbw = p_bad & nsf
    m_pws = p_wrong & sphfire
    m_pww = p_wrong & nsf
    m_sphw = wall0 & sphfire
    m_wallm = wall0 & nsf
    a = a & ~(p_bad | p_wrong | wall0)

    # ---- merged terminal + survivor writes ----
    sphm = m_presph | m_sph2 | m_pbs | m_pws | m_sphw
    wallT = m_yhit | m_ryhit | m_wall2 | m_pbw | m_pww | m_wallm
    term = sphm | wallT
    near = m_yhit | m_ryhit | m_wall2
    my2 = m_yhit | m_ryhit
    ldir_ry = W_(ray_y2 < 0.0, FYN, FYP)
    cont2 = a & stepped
    pgo2 = a & pgo
    cn = cont2 | near
    cw = cont2 | m_wall2
    colid = W_(m_yhit, W_(gy > 0, C_CEIL, C_FLOOR),
               W_(m_ryhit, W_(ray_y2 >= 0.0, C_CEIL, C_FLOOR),
                  W_(m_pww, C_MAGENTA,
                     W_(m_wallm & (s.ldir == FYP), C_CEIL, C_WALL))))
    new_tmeta = W_(term, W_(sphm, T_SPHERE, T_WALL | (colid << 2)),
                   s.tmeta)
    new_pos = V3(W_(pgo2, p["px_f"], W_(cn, pos3.x, pos.x)),
                 W_(cw, pos3.y, W_(my2, pos2.y, pos.y)),
                 W_(pgo2, p["pz_f"], W_(cn, pos3.z, pos.z)))
    new_ray = V3(W_(pgo2, p["vx_r"], ray.x),
                 W_(cont2, ray3.y, W_(m_presph | m_ryhit, ray_y2, ray.y)),
                 W_(pgo2, p["vz_r"], ray.z))
    new_wd = V3(W_(pgo2, p["wx_r"], W_(cont2, wnx, wdist.x)),
                W_(cont2, wny, wdist.y),
                W_(pgo2, p["wz_r"], W_(cont2, wnz, wdist.z)))
    new_ia = V3(W_(pgo2, p["ix_r"], iavel.x), iavel.y,
                W_(pgo2, p["iz_r"], iavel.z))
    new_gx = W_(pgo2, p["gx_r"], gx)
    new_gz = W_(pgo2, p["gz_r"], gz)
    new_cx = W_(cont2, cx2, W_(pgo2, cx_f, s.cx))
    new_cz = W_(cont2, cz2, W_(pgo2, cz_f, s.cz))
    new_cd = W_(cn, cdist2, W_(sphm, s.aux_dist, s.cdist))
    new_fog = W_(cont2 | m_yhit | m_wall2, fog2,
                 W_(m_sph2, s.fog + extra, s.fog))
    new_ld = W_(cont2, ldir3,
                W_(pgo2, p["ldir_p"],
                   W_(m_ryhit, ldir_ry,
                      W_(m_yhit | m_wall2, ldir2, s.ldir))))
    new_ent = W_(cont2 | pgo2, f_next, s.ent)

    s = s._replace(pos=new_pos, ray=new_ray, wdist=new_wd, iavel=new_ia,
                   ent=new_ent, gx=new_gx.to(I32), gz=new_gz.to(I32),
                   cx=new_cx.to(I32), cz=new_cz.to(I32),
                   page=W_(pgo2, p["dpage"], s.page).to(I32), cdist=new_cd,
                   fog=new_fog, ldir=new_ld.to(I32),
                   tmeta=new_tmeta.to(I32), active=s.active & ~term)

    # ---- hoisted-sphere line-change bookkeeping ----
    if hoisted:
        ev_shift = (stepped & (tr1 | tr2 | ramp_go)
                    & (((s.sph_dirty >> 1) & 1) != 0))
        ev = pgo2 | ev_shift
        drop = ev & (s.aux_dist != -1.0) & (s.cdist < s.aux_t0)
        dirty_p = (s.sph_dirty if nr is None
                   else torch.where(nr, 3, 0).to(I32))
        s = s._replace(
            sph_dirty=W_(pgo2, dirty_p,
                         W_(ev_shift, s.sph_dirty | 1, s.sph_dirty)),
            aux_dist=W_(drop, -1.0, s.aux_dist))

    # ---- end-of-iteration sphere check ----
    end_sph = s.active & (s.aux_dist != -1.0) & (s.cdist > fire)
    return s._replace(tmeta=W_(end_sph, T_SPHERE, s.tmeta).to(I32),
                      cdist=W_(end_sph, s.aux_dist, s.cdist),
                      active=s.active & ~end_sph)


def run_segment(wt: TorchWorld, cfg: RenderConfig, math: Math, ifrom: V3,
                iray: V3, active, page, counts: dict | None = None
                ) -> SegOut:
    """March every active lane, starting on `page` (i32 [n]), until it
    terminates or the step budget runs out (tracer_core.run_segment).
    The loop steps only the lanes still active, compacting the working
    set as lanes die; a dead lane's state is final, so this is the same
    as stepping every lane.

    counts, when given, accumulates the work these rays needed (what the
    kernel's bound is computed from): `segments` traced, DDA `steps`
    taken by live lanes, and in parity mode the bucket `slot_tests` and
    the `slot_hits` among them that run the exact div and sqrt."""
    use_skip = cfg.space_skip and not cfg.parity and wt.skip_ok
    hoisted = not cfg.parity and wt.n_spheres > 0
    s = init_segment(wt, ifrom, iray, active, math, page)
    if hoisted:
        s = _apply_aux(s, sphere_all(wt, s, s.active, merge=False,
                                     math=math))
    full = s
    idx = torch.nonzero(s.active).flatten()
    s = _tmap(lambda v: v[idx], s)
    n_live = idx.numel()
    if counts is not None:
        counts["segments"] += n_live
    step = 0
    while step < cfg.maxsteps and idx.numel() > 0:
        if counts is not None:
            counts["steps"] += n_live
        s = segment_body(wt, s, use_skip, hoisted, math, counts)
        step += 1
        live = s.active
        n_live = int(live.sum())
        if n_live < idx.numel():
            if 2 * n_live <= idx.numel() or n_live == 0:
                dead = ~live
                didx = idx[dead]
                full = _tmap2(lambda f, v: f.index_copy(0, didx, v[dead]),
                              full, s)
                idx = idx[live]
                s = _tmap(lambda v: v[live], s)
    full = _tmap2(lambda f, v: f.index_copy(0, idx, v), full, s)
    # still-active rays ran out of steps: sky colour = current ray dir
    full = full._replace(tmeta=torch.where(full.active, T_SKY, full.tmeta))
    return seg_out_view(wt, full, math)


def seg_out_view(wt: TorchWorld, s: SegState, math: Math) -> SegOut:
    refl, apos, anorm, acol = sphere_view(wt, s, math)
    return SegOut(tkind=s.tmeta & 3, tldir=s.ldir,
                  tcolid=(s.tmeta >> 2) & 3, tfog=s.fog, tdist=s.cdist,
                  tpos=s.pos, tray=s.ray, tpage=s.page, aux_refl=refl,
                  aux_pos=apos, aux_norm=anorm, aux_col=acol)


# ---- shading, bounce, unwind -----------------------------------------------

def _palette(colid, chan: int):
    W_ = torch.where
    p = [float(PAL[k, chan]) for k in range(4)]
    z = torch.zeros(colid.shape, dtype=F32, device=colid.device)
    return W_(colid == 0, z + p[0], W_(colid == 1, z + p[1],
                                       W_(colid == 2, z + p[2], z + p[3])))


def shade_and_bounce(out: SegOut, icol: C4, seed, sec: float,
                     depth_ok: bool, math: Math):
    """Wall shading + bounce prep (tracer_core.shade_and_bounce, with
    the animated water normal)."""
    W_ = torch.where
    rx, ry, rz = out.tray.x, out.tray.y, out.tray.z
    ld = out.tldir
    d = W_(ld == FYP, ry, W_(ld == FZP, rz, W_(ld == FXN, -rx,
                             W_(ld == FYN, -ry, W_(ld == FZN, -rz, rx)))))
    d = _max(d, 0.0)
    d = 0.9 * d + 0.1
    zero = torch.zeros_like(d)
    wallcol = C4(_palette(out.tcolid, 0), _palette(out.tcolid, 1),
                 _palette(out.tcolid, 2), zero)
    base_wall = icol * wallcol * d
    is_wall = out.tkind == T_WALL
    is_sph = out.tkind == T_SPHERE
    sky4 = C4(rx, ry, rz, zero)
    base = base_wall.where(is_wall, out.aux_col.where(is_sph, sky4))
    refl = W_(is_wall, W_(ld == FYN, 0.7, 0.25),
              W_(is_sph, out.aux_refl, 0.0))
    bounce = (is_wall | is_sph) & (refl != 0.0) & depth_ok

    pos, ray = out.tpos, out.tray
    eps = 0.001
    negx = (ld == FXP) | (ld == FXN)
    negz = (ld == FZP) | (ld == FZN)
    negy = ld == FYP
    mray = V3(W_(is_wall & negx, -rx, rx), W_(is_wall & negy, -ry, ry),
              W_(is_wall & negz, -rz, rz))
    nudx = W_(ld == FXP, -eps, W_(ld == FXN, eps, 0.0))
    nudy = W_((ld == FYP) | (ld == FYN), -eps, 0.0)
    nudz = W_(ld == FZP, -eps, W_(ld == FZN, eps, 0.0))
    mpos = (pos + V3(nudx, nudy, nudz)).where(is_wall, pos)

    is_water = is_wall & (ld == FYN)
    ang = _PI_TWO * ((math.sin(_PI_HALF * mpos.x)
                      + math.cos(_PI_HALF * mpos.z)) + sec)
    wnorm = normalise_sse(V3(math.sin(ang), torch.full_like(ang, 38.0),
                             math.cos(ang)), math.rsq)
    norm = wnorm.where(is_water, out.aux_norm)

    mpos = (out.aux_pos - ray * 0.001).where(is_sph, mpos)

    mirror = is_water | is_sph
    rmul = -2.0 * (((0.0 + ray.x * norm.x) + ray.y * norm.y)
                   + ray.z * norm.z)
    mirrored = normalise_sse(norm * rmul + ray, math.rsq)
    mray = mirrored.where(mirror, mray)

    # reflect blur: 5 draws, 2 discarded (trace.h:77-84)
    rb = 0.03
    seed, v = lcg.randfs(seed)
    mx = mray.x + v * rb
    seed, v = lcg.randfs(seed)
    my = mray.y + v * rb
    seed, _ = lcg.randfs(seed)
    seed, v = lcg.randfs(seed)
    mz = mray.z + v * rb
    seed, _ = lcg.randfs(seed)
    return base, refl, bounce, mpos, V3(mx, my, mz), seed


def check_config(cfg: RenderConfig, n_pages: int = 1) -> None:
    """Raise on every RenderConfig feature the port does not run, on a
    world of n_pages pages.
    The Mosaic layout knobs (step_chunk, pack_carry, trace_2d,
    tile_rect, span_fetch, mesh_bands) leave the bits unchanged and are
    ignored."""
    missing = [name for name, bad in (
        ("fused=True", cfg.fused), ("profile=True", cfg.profile),
        ("probe", bool(cfg.probe)), ("water=False", not cfg.water),
        ("paged worlds in parity mode", cfg.parity and n_pages > 1))
        if bad]
    if missing:
        raise NotImplementedError(
            "not ported yet: " + ", ".join(missing))


# Weyl increment between the seed streams of two samples
# (tracer_core.py:1810)
WEYL = 0x9E3779B9


def trace_wave_env(wt: TorchWorld, cfg: RenderConfig, ifrom: V3,
                   iray: V3, seed, sec, page,
                   counts: dict | None = None):
    """Full multi-bounce trace (tracer_core.trace_wave_env, unfused).
    seed: int64 uint32 states; page: i32 [n] start page of each ray.
    Returns (col: C4, dist).

    The primary wave consumes no RNG, so it is traced once and shared:
    each of the cfg.samples chains shades it with its own seed stream
    (seed + k*WEYL in uint32) and runs waves 1..reflect.  The colour is
    the chains' mean, summed in sample order and scaled by
    f32(1/samples); dist is the primary wave's."""
    check_config(cfg, wt.n_pages)
    math = make_math(wt, cfg.parity)
    sec = float(np.float32(sec))
    one = torch.ones_like(ifrom.x)
    icol0 = C4(one, one, one, one)
    out0 = run_segment(wt, cfg, math, ifrom, iray, one > 0.0, page, counts)

    def chain(seed):
        """Shade + bounce waves 1.. from the shared primary SegOut, then
        the backward unwind blend (tracer_core.py:1774-1802)."""
        bases, refls, bounces, fogs = [], [], [], []
        out, icol = out0, icol0
        for k in range(cfg.n_waves):
            if k > 0:
                out = run_segment(wt, cfg, math, cur_from, cur_ray, active,
                                  pg, counts)
            pg = out.tpage    # bounce waves continue in the hit's page
            base, refl, bounce, mpos, mray, seed = shade_and_bounce(
                out, icol, seed, sec, k < cfg.reflect, math)
            bases.append(base)
            refls.append(refl)
            bounces.append(bounce)
            fogs.append(out.tfog)
            icol = base
            cur_from, cur_ray = mpos, mray
            active = bounce
        col = bases[-1]
        for k in range(cfg.n_waves - 2, -1, -1):
            blended = col * refls[k] + bases[k] * (1.0 - refls[k])
            fogf = math.exp(-0.6 * fogs[k])
            fogged = blended * fogf + (1.0 - fogf)
            res = fogged.where(fogs[k] != 0.0, blended)
            col = res.where(bounces[k], bases[k])
        return col

    if cfg.samples == 1:
        return chain(seed), out0.tdist
    acc = chain(seed)
    for k in range(1, cfg.samples):
        # uint32 held in int64: mask after the add (k*WEYL >= 2^31)
        acc = acc + chain((seed + ((k * WEYL) & 0xFFFFFFFF)) & 0xFFFFFFFF)
    inv = float(np.float32(1.0 / cfg.samples))
    return acc * inv, out0.tdist


def col_ftoint(col: C4) -> torch.Tensor:
    """BGRA8 pack (tracer_core.col_ftoint): round half to even, <0 -> 0,
    >255 -> 255, v >= 2^31 or NaN -> 0.  Returns the uint32 word's bits
    as int32."""
    def one(c, shift):
        v = c * 255.0
        r = torch.round(v)
        bad = (v >= 2147483648.0) | torch.isnan(v)
        b = torch.where(bad, 0, torch.clamp(r, 0.0, 255.0).to(torch.int64))
        return b << shift

    packed = one(col.b, 0) | one(col.g, 8) | one(col.r, 16) | one(col.a, 24)
    return lcg.to_i32_bits(packed)
