# Frozen copy of pwnfps_tpu_torch/world/cells.py (commit fea5a14) for the
# benchmark's plain reference.  It imports nothing of pwnfps_tpu_torch,
# pwnfps_tpu or jax; later changes to the program do not reach it.
"""Cell-type semantics.  Copied from pwnfps_tpu/world/cells.py.

The reference stores raw ASCII chars in a 64x64 grid and branches on them
in the hot loop (trace.h:300-666) and in player physics
(util.h:112-158).  The TPU design precompiles every cell
into small integer/float *channels* so the tracer never branches on chars:

  cls   - cell class id (below)
  rcx/rcz - ramp tilt coefficients: ray.y += rcx*ray.x + rcz*ray.z on entry
  pkind - portal kind: 0 none / 1 endpoint / 2 incomplete / 3 wrong-endpoint
  pdcx/pdcz - portal cell translation, prot - quarter-turns (0..3)
  xcls  - class used by the 2-high wall check after portal substitution
          (trace.h:404-413)
"""

from __future__ import annotations

# class ids (kept dense & small so masks are cheap on the VPU)
CLS_WALL = 0      # '.', any unknown char
CLS_FLOOR = 1     # ';'
CLS_FOG = 2       # '$'  (1-high + fog accumulation)
CLS_LOWER = 3     # '"'  (1-high room sunk by 1 relative to '#'/'&')
CLS_TALL = 4      # '#'  (2-high room)
CLS_TALLFOG = 5   # '&'  (2-high + fog)
CLS_RAMP = 6      # '>' '<' ',' '^'
CLS_PORTAL = 7    # 'A'..'Z'

_CHAR_CLS = {
    ord(";"): CLS_FLOOR,
    ord("$"): CLS_FOG,
    ord('"'): CLS_LOWER,
    ord("#"): CLS_TALL,
    ord("&"): CLS_TALLFOG,
    ord(">"): CLS_RAMP,
    ord("<"): CLS_RAMP,
    ord(","): CLS_RAMP,
    ord("^"): CLS_RAMP,
}

# ramp tilt coefficients - trace.h:450-457 (ramp_delta=0.5)
_RAMP_COEF = {
    ord(">"): (-0.5, 0.0),
    ord("<"): (+0.5, 0.0),
    ord(","): (0.0, -0.5),
    ord("^"): (0.0, +0.5),
}


def char_class(c: int) -> int:
    """ASCII code -> cell class id."""
    if ord("A") <= c <= ord("Z"):
        return CLS_PORTAL
    return _CHAR_CLS.get(c, CLS_WALL)


def ramp_coef(c: int) -> tuple[float, float]:
    return _RAMP_COEF.get(c, (0.0, 0.0))


def celltype_is_free(c: int) -> bool:
    """util.h:129-138 - cells a portal may open into."""
    return c in (
        ord(";"), ord("$"), ord('"'), ord("#"), ord("&"),
        ord(">"), ord("<"), ord("^"), ord(","),
    )


def celltype_is_solid(c: int, oldcell: int, y: float, portal_open) -> bool:
    """util.h:112-126 - height-dependent solidity.

    `portal_open(letter_index) -> bool` reports whether pmap[i].x2 != -1.
    `oldcell` implements the '"-after-#/&' -1 y-shift rule (util.h:114-115).
    """
    if c == ord('"') and oldcell in (ord("#"), ord("&")):
        return y < 1.0 or y >= 2.0
    if c in (ord("#"), ord("&")):
        return y < 0.0 or y >= 2.0
    if c in (ord(";"), ord("$"), ord('"')):
        return y < 0.0 or y >= 1.0
    if c in (ord(">"), ord("<"), ord("^"), ord(",")):
        return y < 0.0 or y >= 1.0
    if ord("A") <= c <= ord("Z"):
        return not portal_open(c - ord("A"))
    return True
