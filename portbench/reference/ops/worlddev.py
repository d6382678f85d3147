# Frozen copy of pwnfps_tpu_torch/ops/worlddev.py (commit fea5a14) for the
# benchmark's plain reference.  It imports nothing of pwnfps_tpu_torch,
# pwnfps_tpu or jax; later changes to the program do not reach it.
"""Device-resident world representation.
Copied from pwnfps_tpu/ops/worlddev.py (the portal slot tables are not
copied: the port reads portal fields straight from the word table).

The tracer's inner loop needs, per DDA step and per ray, everything about
the current cell.  Instead of the reference's char switch
(trace.h:300), we pre-pack all per-cell channels into ONE
int32 word so a step costs a single gather:

  bits  0..3   cls    cell class (see below)
  bits  4..5   pkind  0 plain / 1 portal endpoint / 2 incomplete / 3 wrong
  bits  6..7   prot   portal quarter-turns to apply
  bits  8..11  xcls   behind-cell class for the 2-high wall check
  bits 12..18  pdcx   portal cells: cell delta x, biased +64;
               12..19 non-portal cells: same-class run lengths
                      (run_x | run_z << 4, the empty-space skip)
  bits 19..25  pdcz   portal cells: cell delta z, biased +64
  bits 26..29  nsph   per-cell sphere-bucket count (rebuilt per frame)

Paged worlds (ops beyond one 64x64 grid, e.g. the 1024-sector maze):
all tables grow a leading page axis flattened in (page*4096 + cz*64 +
cx); each ray carries its page and portals may jump pages via a target
page stored in the nsph bits of the PORTAL cell (paged worlds therefore
forbid sphere buckets on portal cells - build_world_paged raises).  A
single-page world is the degenerate case and keeps the reference's
semantics exactly (portal cells may hold buckets, nsph means count).

Run lengths (fast-mode empty-space skip): for a cell of class c in
{FLOOR, FOG, LOWER, TALL, TALLFOG}, run_a <= 15 counts the same-class
neighbours on BOTH sides along axis a; a ray may take its next a-axis
crossing up to run_a+1 cells out when no transverse crossing intervenes
(clearance_static).  Skipped interior cells are class-uniform, so no
per-cell semantics (transitions, fog rate changes) are lost - sphere
candidates are hoisted out of the loop separately.  The reference
walks these runs one cell at a time (trace.h:247-250).

Classes here refine world.cells with per-ramp-direction ids (the tilt
coefficient is derived from the class in-kernel):
  0 wall, 1 ';', 2 '$', 3 '"', 4 '#', 5 '&',
  6 '>', 7 '<', 8 ',', 9 '^', 10 portal
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np

from ..core.approx import SseTables
from ..world.levelc import LevelData
from ..world.objects import SphereSet

# refined class ids
WALL, FLOOR, FOG, LOWER, TALL, TALLFOG = 0, 1, 2, 3, 4, 5
RAMP_GT, RAMP_LT, RAMP_CM, RAMP_CR, PORTAL = 6, 7, 8, 9, 10

_RAMP_IDS = {ord(">"): RAMP_GT, ord("<"): RAMP_LT,
             ord(","): RAMP_CM, ord("^"): RAMP_CR}
_BASE_IDS = {ord(";"): FLOOR, ord("$"): FOG, ord('"'): LOWER,
             ord("#"): TALL, ord("&"): TALLFOG}


def refined_class(c: int) -> int:
    if ord("A") <= c <= ord("Z"):
        return PORTAL
    if c in _RAMP_IDS:
        return _RAMP_IDS[c]
    return _BASE_IDS.get(c, WALL)


class WorldDev(NamedTuple):
    """Pytree of device arrays describing the world for one frame."""

    word: np.ndarray        # [4096] int32 packed channels (incl. counts)
    buckets: np.ndarray     # [4096 * K] int32 sphere indices (-1 pad)
    sph_pos: np.ndarray     # [NS, 3] f32
    sph_r: np.ndarray       # [NS] f32
    sph_refl: np.ndarray    # [NS] f32
    sph_col: np.ndarray     # [NS, 3] f32 (b, g, r)
    rsqrt_tab: np.ndarray   # [8192] uint32
    rcp_tab: np.ndarray     # [4096] uint32


@dataclasses.dataclass(frozen=True)
class WorldMeta:
    """Static (hashable) companion of WorldDev for jit specialization."""

    k_bucket: int          # bucket slots the tracer must scan (0 = none)
    n_spheres: int
    # any nonzero clearance cell?  False on tight mazes, letting the
    # tracer strip the empty-space-skip ops from the step body entirely
    has_clear: bool = False
    # rows of the 64x64 grid that hold level content or spheres, rounded
    # up to a multiple of 8.  The pallas backend sizes its cell-table
    # gather chunks by this: rows beyond it are uniform pad whose packed
    # compact byte is 0 == the chunked-gather miss value, so trimming is
    # bit-exact (tracer_pallas.build_tables).
    lh: int = 64
    # grid-column budget of the COMPACT cell table (64 or 32): 32 when
    # every content/sphere column sits below 32, letting the pallas
    # fetch re-stride the compact table to lw columns and scan HALF
    # the gather chunks.  Columns >= lw are '.'-pad (compact byte 0)
    # by this derivation, and the trimmed index formula maps them past
    # the table so they read the same 0 (tracer_core.
    # flat_cell_index_lw).  The full word/mask tables keep the
    # 64-stride layout (rare/parity paths, not worth the re-stride).
    lw: int = 64
    # pages in the world atlas (1 = the reference's single 64x64 grid)
    n_pages: int = 1
    # page of every sphere (paged worlds keep all spheres on one page;
    # the hoisted candidate pass gates on it)
    sphere_page: int = 0
    # padded per-page portal-slot capacity (multiple of 128), or 0 to
    # disable the slot path (some page holds > 256 portals, or a
    # hand-built meta that never computed it).  When set, portal
    # cells' compact entry carries a dense slot id in the
    # (otherwise-zero) run bits, so the rare portal fetch gathers ONE
    # packed record from a [n_pages * pslots] table instead of
    # scanning the full per-cell word table (portal_slot_tables).
    pslots: int = 0
    # bound-sphere gate slack (tracer_core brq2 = br*br + sph_slack):
    # 0.04 for game-scale scenes, widened quadratically (power-of-two
    # quantized) for scenes outside the derivation envelope so the
    # gates stay sound supersets there (_sphere_slack).
    sph_slack: float = 0.04


def _cls_to_refined(level: LevelData) -> np.ndarray:
    g = level.grid
    out = np.zeros((64, 64), np.int32)
    for z in range(64):
        for x in range(64):
            out[z, x] = refined_class(int(g[z, x]))
    return out


def pack_static_word(level: LevelData) -> np.ndarray:
    """The frame-invariant part of the channel word, [4096] int32."""
    ch = level.channels()
    cls = _cls_to_refined(level)
    # xcls only needs to distinguish tall-like vs lower vs other
    xcls = np.zeros((64, 64), np.int32)
    grid = level.grid
    for z in range(64):
        for x in range(64):
            c = int(grid[z, x])
            xc = c
            if ord("A") <= c <= ord("Z"):
                pm = level.pmap[c - ord("A")]
                if pm.x1 == x and pm.z1 == z:
                    xc = pm.c2
                elif pm.x2 == x and pm.z2 == z:
                    xc = pm.c1
            xcls[z, x] = refined_class(int(xc))
    # the biased portal deltas are written only on portal cells so that
    # bits 12..15 of plain cells stay free for the clearance channel
    is_portal = cls == PORTAL
    word = (cls
            | (ch["pkind"] << 4)
            | (ch["prot"] << 6)
            | (xcls << 8)
            | np.where(is_portal, (ch["pdcx"] + 64) << 12, 0)
            | np.where(is_portal, (ch["pdcz"] + 64) << 19, 0)
            ).astype(np.int32)
    return word.reshape(-1)


_ELIG = (FLOOR, FOG, LOWER, TALL, TALLFOG)
CLEAR_MAX = 15


def _sym_runs(same: np.ndarray, axis: int) -> np.ndarray:
    """Per cell: min(#same-class neighbours left, right) along `axis`
    (cells beyond the grid count as different)."""
    n = same.shape[axis]
    fwd = np.zeros_like(same, np.int32)
    bwd = np.zeros_like(same, np.int32)
    sl = [slice(None)] * same.ndim

    def at(i):
        sl2 = list(sl)
        sl2[axis] = i
        return tuple(sl2)

    for i in range(1, n):
        fwd[at(i)] = np.where(same[at(i)] & same[at(i - 1)],
                              fwd[at(i - 1)] + 1, 0)
    for i in range(n - 2, -1, -1):
        bwd[at(i)] = np.where(same[at(i)] & same[at(i + 1)],
                              bwd[at(i + 1)] + 1, 0)
    return np.minimum(fwd, bwd)


def clearance_static(static_word: np.ndarray) -> np.ndarray:
    """[64,64] per-cell same-class run lengths: run_x | run_z << 4.

    run_a = r means the 2r+1 cells centred here along axis `a` share
    this cell's class, so a ray may take its next crossing on that axis
    up to r+1 cells out, provided no transverse crossing intervenes -
    the strip it sweeps has no observable per-cell semantics (uniform
    fog rate, no transitions, no portals; sphere candidates are hoisted
    out of the loop entirely).  See segment_body's empty-space skip."""
    cls = (static_word.reshape(64, 64) & 0xF).astype(np.int32)
    rx = np.zeros((64, 64), np.int32)
    rz = np.zeros((64, 64), np.int32)
    for c in _ELIG:
        same = cls == c
        if not same.any():
            continue
        rx = np.where(same, _sym_runs(same, 1), rx)
        rz = np.where(same, _sym_runs(same, 0), rz)
    rx = np.clip(rx, 0, CLEAR_MAX)
    rz = np.clip(rz, 0, CLEAR_MAX)
    return rx | (rz << 4)


def _sphere_slack(spheres: SphereSet) -> float:
    """Build-time bound-sphere slack for the fast path's hoist gates.

    The hoist gate's brq2 = br*br + slack (tracer_core
    make_sphere_all/make_sphere_rel) needs slack >= the gate
    expressions' f32 evaluation error, or a scene could silently
    under-gate the hoist (dropping real sphere hits with no test
    tripping - round-3 advisor finding).  0.04 is the derived constant
    for game-scale scenes (centres in [-1,65]x[-2,3]x[-1,65], r <= 2:
    compare-rounding ~1.6e-2 + projection error ~1.2e-2 < 0.04).  Both
    error terms are sums of PRODUCTS of two coordinate-scale
    quantities, so they grow quadratically with the scene's coordinate
    magnitude; scenes outside the envelope (e.g. a script-animated
    sphere drifting out mid-game - round-4 advisor finding: this used
    to raise per frame) get the 0.04 widened by the squared scale
    ratio instead of a crash.  Widening is always SOUND: the gates are
    conservative supersets, so a looser gate only fires the (exact,
    idempotent) refresh more often - bits are unchanged, only perf.
    The ratio is quantized to power-of-two steps so an animated sphere
    does not retrigger jit specialization every frame (slack is a
    static WorldMeta field)."""
    live = np.asarray(spheres.r, np.float32) > 0
    if not live.any():
        return 0.04
    pos = np.asarray(spheres.pos, np.float32)[live]
    r = np.asarray(spheres.r, np.float32)[live]
    in_env = bool(((pos[:, 0] >= -1) & (pos[:, 0] <= 65)
                   & (pos[:, 2] >= -1) & (pos[:, 2] <= 65)
                   & (pos[:, 1] >= -2) & (pos[:, 1] <= 3)
                   & (r <= 2.0)).all())
    if in_env:
        return 0.04     # the derived constant, bit-for-bit
    # max squared centre-to-ray distance the gate expressions can see:
    # rays stay inside the grid (x/z in [0,64], y within ~[-1,3] of the
    # floor band), so rel_x/z <= |c|+r+64 and rel_y <= |c|+r+4, floored
    # at the envelope's own per-axis maxima (67, 6, 67).
    m = np.abs(pos) + r[:, None]
    d2 = (max(float(m[:, 0].max()) + 64.0, 67.0) ** 2
          + max(float(m[:, 1].max()) + 4.0, 6.0) ** 2
          + max(float(m[:, 2].max()) + 64.0, 67.0) ** 2)
    d2_env = 67.0 ** 2 + 6.0 ** 2 + 67.0 ** 2
    k = max(1, math.ceil(math.log2(d2 / d2_env)))
    return 0.04 * float(2 ** k)


def build_world(level: LevelData, spheres: SphereSet, tables: SseTables,
                static_word: np.ndarray | None = None
                ) -> tuple[WorldDev, WorldMeta]:
    if static_word is None:
        static_word = pack_static_word(level)
    sph_slack = _sphere_slack(spheres)
    counts = spheres.counts.reshape(-1).astype(np.int32)
    k_needed = int(counts.max()) if counts.size else 0
    runs = clearance_static(static_word).reshape(-1)
    word = (static_word | (counts << 26) | (runs << 12)).astype(np.int32)
    n = int(np.count_nonzero(spheres.r))
    # number of live spheres: rely on r>0 for set entries; fall back to
    # max bucket index + 1 so zero-radius spheres still count
    if spheres.buckets.size:
        n = max(n, int(spheres.buckets.max()) + 1)
    dev = WorldDev(
        word=word,
        buckets=spheres.buckets.reshape(-1).astype(np.int32),
        sph_pos=spheres.pos.astype(np.float32),
        sph_r=spheres.r.astype(np.float32),
        sph_refl=spheres.refl.astype(np.float32),
        sph_col=spheres.col.astype(np.float32),
        rsqrt_tab=tables.rsqrt,
        rcp_tab=tables.rcp,
    )
    # content rows = anything that isn't the '.' pad fill ('.' packs to
    # class WALL with no portal/xcls channels, byte 0 in the compact
    # table, which is exactly the chunked-gather miss value)
    grid_rows = np.nonzero((level.grid != ord(".")).any(axis=1))[0]
    cnt_rows = np.nonzero(counts.reshape(64, 64).any(axis=1))[0]
    last = max(int(grid_rows.max()) if grid_rows.size else 0,
               int(cnt_rows.max()) if cnt_rows.size else 0)
    lh = min(64, -(-(last + 1) // 8) * 8)
    # column extent the same way (spheres included via the bucket
    # counts): lw=32 halves the pallas compact-fetch chunk scan
    grid_cols = np.nonzero((level.grid != ord(".")).any(axis=0))[0]
    cnt_cols = np.nonzero(counts.reshape(64, 64).any(axis=0))[0]
    lastc = max(int(grid_cols.max()) if grid_cols.size else 0,
                int(cnt_cols.max()) if cnt_cols.size else 0)
    lw = 32 if lastc < 32 else 64
    return dev, WorldMeta(k_bucket=k_needed, n_spheres=max(n, 0),
                          lh=lh, lw=lw,
                          has_clear=bool(runs.any()),
                          pslots=_pslot_capacity(word, 1),
                          sph_slack=sph_slack)


# word decode helpers (work on numpy or jnp int32 arrays)
def w_cls(w):
    return w & 0xF


def w_pkind(w):
    return (w >> 4) & 0x3


def w_prot(w):
    return (w >> 6) & 0x3


def w_xcls(w):
    return (w >> 8) & 0xF


def w_pdcx(w):
    return ((w >> 12) & 0x7F) - 64


def w_pdcz(w):
    return ((w >> 19) & 0x7F) - 64


def w_nsph(w):
    return (w >> 26) & 0xF


def w_runx(w):
    """Same-class run along x; valid only on non-portal cells (portal
    cells keep their biased pdcx in these bits — callers gate on cls)."""
    return (w >> 12) & 0xF


def w_runz(w):
    """Same-class run along z (non-portal cells; bits 16..19 overlay
    the portal pdcx/pdcz area like w_runx)."""
    return (w >> 16) & 0xF


def w_dpage(w):
    """Portal target page (paged worlds): rides the nsph bits, valid
    only on portal cells of a multi-page world (which may not hold
    sphere buckets - enforced by build_world_paged)."""
    return (w >> 26) & 0xF


def _pslot_capacity(words: np.ndarray, n_pages: int) -> int:
    """Padded per-page slot capacity for WorldMeta.pslots: the max
    portal count over pages rounded up to a 128-lane multiple (>= 128,
    so no-portal worlds still route the cross-fired portal fetch to a
    tiny zero table), or 0 when some page exceeds the 8-bit slot-id
    budget of the compact entry (256)."""
    isp = (words.reshape(n_pages, 4096) & 0xF) == PORTAL
    npmax = int(isp.sum(axis=1).max())
    if npmax > 256:
        return 0
    return max(128, -(-npmax // 128) * 128)


def build_world_paged(static_words: np.ndarray, spheres: SphereSet,
                      sphere_page: int, tables: SseTables
                      ) -> tuple[WorldDev, WorldMeta]:
    """Assemble a multi-page world atlas.

    static_words: [P, 4096] int32 packed channel words per page; portal
    cells carry their target page in bits 26..29 (w_dpage).  spheres:
    page-local SphereSet whose buckets live on `sphere_page`."""
    P = static_words.shape[0]
    assert 1 <= P <= 16, P
    sph_slack = _sphere_slack(spheres)
    words = static_words.astype(np.int32).reshape(P, 4096).copy()
    counts = spheres.counts.reshape(-1).astype(np.int32)
    k_needed = int(counts.max()) if counts.size else 0
    if P > 1:
        is_portal = (words & 0xF) == PORTAL
        if (counts[is_portal[sphere_page]] > 0).any():
            raise ValueError(
                "paged worlds cannot hold sphere buckets on portal "
                "cells (their nsph bits carry the target page)")
    for p in range(P):
        words[p] |= clearance_static(words[p]).reshape(-1) << 12
    words[sphere_page] |= counts << 26
    buckets = np.full((P * 4096, spheres.buckets.shape[-1]), -1,
                      np.int32)
    buckets[sphere_page * 4096:(sphere_page + 1) * 4096] = \
        spheres.buckets.reshape(4096, -1)
    n = int(np.count_nonzero(spheres.r))
    if spheres.buckets.size:
        n = max(n, int(spheres.buckets.max()) + 1)
    dev = WorldDev(
        word=words.reshape(-1),
        buckets=buckets.reshape(-1),
        sph_pos=spheres.pos.astype(np.float32),
        sph_r=spheres.r.astype(np.float32),
        sph_refl=spheres.refl.astype(np.float32),
        sph_col=spheres.col.astype(np.float32),
        rsqrt_tab=tables.rsqrt,
        rcp_tab=tables.rcp,
    )
    has_clear = bool(((words >> 12) & 0xFF)[(words & 0xF) != PORTAL]
                     .any())
    return dev, WorldMeta(k_bucket=k_needed, n_spheres=max(n, 0),
                          lh=64, n_pages=P, sphere_page=sphere_page,
                          has_clear=has_clear,
                          pslots=_pslot_capacity(words, P),
                          sph_slack=sph_slack)
