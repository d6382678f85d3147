"""Level compiler: ASCII map -> device-ready channel arrays.
Copied from pwnfps_tpu/world/levelc.py.

The reference parses the map at startup into a char grid plus a 26-entry
portal table (level.h:107-228).  We reproduce the parser
exactly - including its deliberate quirks - then *compile* the result into
per-cell numeric channels so the TPU tracer is branch-free over chars.

Parser quirks reproduced on purpose (each is observable in rendered output):

  * rows shorter than 64 are padded with '.'; empty lines are skipped
    without advancing the row index (level.h:118-135);
  * '*' marks the spawn and becomes ';' (level.h:137-142);
  * a lowercase letter 'a'..'y' registers an endpoint for *its own* portal
    slot and is then rewritten to the *next* uppercase letter
    (c = (c-'a')+'A'+1, level.h:144-161), which registers the endpoint
    again under that shifted slot (level.h:163-178).  This aliasing is how
    level authors build one-way / multi-way "euclidfuckery";
  * portals with only one endpoint (x2 == -1) render as walls;
  * a third-or-later occurrence of an uppercase letter is a wrong-endpoint
    cell and renders as the magenta debug wall (trace.h:547-559);
  * rot12 = (d2 - d1 + 2) & 3 from the facing dirs of the two endpoints,
    and c1/c2 capture the cells behind each endpoint (level.h:194-218).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.config import FXP, FZP, FXN, FZN
from . import cells as C


@dataclasses.dataclass
class Portal:
    x1: int = -1
    z1: int = -1
    x2: int = -1
    z2: int = -1
    rot12: int = 0
    c1: int = ord(";")
    c2: int = ord(";")

    @property
    def open(self) -> bool:
        return self.x2 != -1


@dataclasses.dataclass
class LevelData:
    grid: np.ndarray              # [64,64] uint8 ASCII codes, grid[z][x]
    spawn: tuple[int, int]        # (sx, sz)
    pmap: list[Portal]            # 26 entries

    # -- host-side queries (player physics / script API) -------------------
    def get_cell(self, cx: int, cz: int) -> int:
        # OOB clamps to cell (0,0) - util.h:151-158
        if cx < 0 or cx >= 64:
            cx = 0
        if cz < 0 or cz >= 64:
            cz = 0
        return int(self.grid[cz, cx])

    def is_solid(self, c: int, oldcell: int, y: float) -> bool:
        return C.celltype_is_solid(
            c, oldcell, y, lambda i: self.pmap[i].open
        )

    # -- compilation to channel arrays --------------------------------------
    def channels(self) -> dict[str, np.ndarray]:
        """Per-cell channels consumed by the tracer. All [64,64] numpy."""
        g = self.grid
        cls = np.zeros((64, 64), np.int32)
        rcx = np.zeros((64, 64), np.float32)
        rcz = np.zeros((64, 64), np.float32)
        pkind = np.zeros((64, 64), np.int32)
        pdcx = np.zeros((64, 64), np.int32)
        pdcz = np.zeros((64, 64), np.int32)
        prot = np.zeros((64, 64), np.int32)
        xcls = np.zeros((64, 64), np.int32)

        for z in range(64):
            for x in range(64):
                c = int(g[z, x])
                k = C.char_class(c)
                cls[z, x] = k
                rcx[z, x], rcz[z, x] = C.ramp_coef(c)
                xc = c  # default: the cell itself
                if k == C.CLS_PORTAL:
                    pm = self.pmap[c - ord("A")]
                    if not pm.open:
                        pkind[z, x] = 2  # incomplete -> wall
                        # half-open portals still substitute via pmap
                        # defaults (c1 = c2 = ';') when they match e1
                        if pm.x1 == x and pm.z1 == z:
                            xc = pm.c2
                    elif pm.x1 == x and pm.z1 == z:
                        pkind[z, x] = 1
                        pdcx[z, x] = pm.x2 - pm.x1
                        pdcz[z, x] = pm.z2 - pm.z1
                        prot[z, x] = (-pm.rot12) & 3
                        xc = pm.c2
                    elif pm.x2 == x and pm.z2 == z:
                        pkind[z, x] = 1
                        pdcx[z, x] = -(pm.x2 - pm.x1)
                        pdcz[z, x] = -(pm.z2 - pm.z1)
                        prot[z, x] = pm.rot12 & 3
                        xc = pm.c1
                    else:
                        pkind[z, x] = 3  # wrong endpoint -> magenta wall
                xcls[z, x] = C.char_class(int(xc))

        return dict(cls=cls, rcx=rcx, rcz=rcz, pkind=pkind,
                    pdcx=pdcx, pdcz=pdcz, prot=prot, xcls=xcls)


def _find_free_dir_2d(grid: np.ndarray, x: int, z: int) -> int:
    """util.h:140-149 - scan order +X, +Z, -X, -Z."""
    assert 1 <= x <= 62 and 1 <= z <= 62, (
        f"portal endpoint at grid border ({x},{z}); the reference reads "
        "out of bounds here - unsupported by design")
    if C.celltype_is_free(int(grid[z, x + 1])):
        return FXP
    if C.celltype_is_free(int(grid[z + 1, x])):
        return FZP
    if C.celltype_is_free(int(grid[z, x - 1])):
        return FXN
    if C.celltype_is_free(int(grid[z - 1, x])):
        return FZN
    return FXP  # reference: "stuff it"


_BEHIND = {FXP: (1, 0), FZP: (0, 1), FXN: (-1, 0), FZN: (0, -1)}


def compile_level(text: bytes | str) -> LevelData:
    """Parse + link a level, mirroring level_load (level.h:107-228)."""
    if isinstance(text, str):
        text = text.encode("latin-1")
    grid = np.full((64, 64), ord("."), np.uint8)
    pmap = [Portal() for _ in range(26)]
    sx = sz = 0

    def register(pm: Portal, x: int, z: int) -> None:
        if pm.x1 == -1:
            pm.x1, pm.z1 = x, z
        elif pm.x2 == -1:
            pm.x2, pm.z2 = x, z

    i = 0
    n = len(text)
    done = False
    for z in range(64):
        if done:
            break
        x = 0
        while x < 64:
            if i >= n:
                done = True
                break
            c = text[i]
            i += 1
            if c in (0x0D, 0x0A):  # '\r' or '\n'
                if x == 0:
                    continue       # consumed; stay at x==0 (skips empties)
                break              # end of row
            if c == ord("*"):
                c = ord(";")
                sx, sz = x, z
            if ord("a") <= c <= ord("z") - 1:
                register(pmap[c - ord("a")], x, z)
                c = (c - ord("a")) + ord("A") + 1
            if ord("A") <= c <= ord("Z"):
                register(pmap[c - ord("A")], x, z)
            grid[z, x] = c
            x += 1

    # portal post-pass: facing dirs -> rot12, behind-cells c1/c2
    for pm in pmap:
        if pm.x2 == -1:
            continue
        d1 = _find_free_dir_2d(grid, pm.x1, pm.z1)
        d2 = _find_free_dir_2d(grid, pm.x2, pm.z2)
        pm.rot12 = (d2 - d1 + 2) & 3
        bx, bz = _BEHIND[d1]
        pm.c1 = int(grid[pm.z1 + bz, pm.x1 + bx])
        bx, bz = _BEHIND[d2]
        pm.c2 = int(grid[pm.z2 + bz, pm.x2 + bx])

    return LevelData(grid=grid, spawn=(sx, sz), pmap=pmap)


def load_level(path: str) -> LevelData:
    with open(path, "rb") as f:
        return compile_level(f.read())
