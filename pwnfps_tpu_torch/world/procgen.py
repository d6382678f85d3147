"""Procedural worlds (BASELINE configs #3 and #2).
Copied from pwnfps_tpu/world/procgen.py (`generate_sector_maze`,
`_portal_site`, `make_portal_chain` and `maze_text`; the cave generator
`generate_maze` needs `jax.random` and is not copied).

The sector maze is a multi-page world atlas: pages of 16 x 16 sectors,
each a 2x2 interior behind 2-thick walls, linked by carved doorways
within a page and by portals across pages, plus random teleport pairs.
The portal chain is a one-page corridor of chained portal pairs.
"""

from __future__ import annotations

import numpy as np

from ..core.config import FXN, FXP, FZN, FZP
from ..ops import worlddev as W
from .levelc import LevelData, compile_level


def generate_sector_maze(seed: int = 0, pages: int = 4,
                         teleports: int = 48):
    """BASELINE config #3 at spec scale: a multi-page world atlas of
    1024 portal-linked sectors (pages x 16 x 16 sectors of 4x4 cells,
    2x2 interiors behind 2-thick walls).

    A randomized spanning tree over the global sector graph guarantees
    every sector is reachable; tree edges between sectors of different
    pages become portals (cross-page jumps ride the channel word's
    dpage bits, ops/worlddev.py), in-page tree edges are carved
    doorways, and `teleports` extra random portal pairs add
    non-euclidean shortcuts.  Portal channel words are emitted directly
    (pkind/prot/deltas exactly as world.levelc.channels would), so the
    26-letter grammar cap does not apply.

    Returns (static_words [pages,4096] int32, meta dict) where meta has
    'sectors', 'portal_pairs', 'spawn' = (page, x, z) and
    'sector_centre' = fn(page, i, j) -> (x, z)."""
    rng = np.random.default_rng(seed)
    S = 16                               # sectors per page side
    P = pages
    assert 1 <= P <= 16

    # grids of '.'-walls; interiors are 2x2 at (4i+1..4i+2, 4j+1..4j+2)
    grids = np.full((P, 64, 64), ord("."), np.uint8)
    for p in range(P):
        for i in range(S):
            for j in range(S):
                grids[p, 4 * i + 1:4 * i + 3, 4 * j + 1:4 * j + 3] = \
                    ord(";")

    # global sector graph: in-page 4-neighbours + cross-page edges
    # linking the right/bottom borders of page p to the left/top
    # borders of page (p+1) % P (an endless non-euclidean ring)
    def nid(p, i, j):
        return (p * S + i) * S + j

    edges = {}

    def add_edge(a, b, kind):
        key = (min(a, b), max(a, b))
        edges.setdefault(key, (a, b, kind))

    for p in range(P):
        for i in range(S):
            for j in range(S):
                if i + 1 < S:
                    add_edge(nid(p, i, j), nid(p, i + 1, j), "v")
                if j + 1 < S:
                    add_edge(nid(p, i, j), nid(p, i, j + 1), "h")
        q = (p + 1) % P
        for i in range(S):
            add_edge(nid(p, i, S - 1), nid(q, i, 0), "x")

    # randomized DFS spanning tree
    adj = {}
    for a, b, kind in edges.values():
        adj.setdefault(a, []).append((b, kind))
        adj.setdefault(b, []).append((a, kind))
    seen = {0}
    stack = [0]
    tree = []
    while stack:
        a = stack[-1]
        nxt = [(b, k) for b, k in adj[a] if b not in seen]
        if not nxt:
            stack.pop()
            continue
        b, kind = nxt[rng.integers(len(nxt))]
        seen.add(b)
        tree.append((a, b, kind))
        stack.append(b)
    assert len(seen) == P * S * S

    def sec(n):
        return n // (S * S), (n // S) % S, n % S

    portal_pairs = []                    # [((p,x,z,d), (p,x,z,d))]
    for a, b, kind in tree:
        pa, ia, ja = sec(a)
        pb, ib, jb = sec(b)
        if kind == "v" and pa == pb:     # carve vertical doorway
            x = 4 * min(ja, jb) + 1
            z0 = 4 * min(ia, ib) + 3
            grids[pa, z0:z0 + 2, x] = ord(";")
        elif kind == "h" and pa == pb:   # carve horizontal doorway
            z = 4 * min(ia, ib) + 1
            x0 = 4 * min(ja, jb) + 3
            grids[pa, z, x0:x0 + 2] = ord(";")
        else:                            # cross-page edge -> portal
            portal_pairs.append((_portal_site(pa, ia, ja, "E"),
                                 _portal_site(pb, ib, jb, "W")))

    # extra non-euclidean teleports between random distant sectors
    sides = ("N", "S", "E", "W")
    occupied = {(s[0], s[1], s[2]) for pr in portal_pairs for s in pr}
    tries = 0
    while teleports > 0 and tries < 4000:
        tries += 1
        pa, ia, ja = (rng.integers(P), rng.integers(S), rng.integers(S))
        pb, ib, jb = (rng.integers(P), rng.integers(S), rng.integers(S))
        if (pa, ia, ja) == (pb, ib, jb):
            continue
        s1 = _portal_site(int(pa), int(ia), int(ja),
                          sides[rng.integers(4)])
        s2 = _portal_site(int(pb), int(ib), int(jb),
                          sides[rng.integers(4)])
        if (s1[0], s1[1], s1[2]) in occupied \
                or (s2[0], s2[1], s2[2]) in occupied:
            continue
        # a carved doorway may have reused this wall cell; portal
        # endpoints need their single-free-neighbour geometry intact
        if grids[s1[0], s1[2], s1[1]] != ord(".") \
                or grids[s2[0], s2[2], s2[1]] != ord("."):
            continue
        occupied.add((s1[0], s1[1], s1[2]))
        occupied.add((s2[0], s2[1], s2[2]))
        portal_pairs.append((s1, s2))
        teleports -= 1

    # pack pages: base cells via the ordinary level compiler (grids
    # hold no letters), portal cells emitted directly
    words = np.zeros((P, 4096), np.int32)
    for p in range(P):
        text = b"\n".join(bytes(grids[p, z]) for z in range(64)) + b"\n"
        lv = compile_level(text)
        words[p] = W.pack_static_word(lv)
    for (s1, s2) in portal_pairs:
        rot12 = (s2[3] - s1[3] + 2) & 3
        for (src, dst, prot) in ((s1, s2, (-rot12) & 3),
                                 (s2, s1, rot12 & 3)):
            sp, sx, sz, _ = src
            dp, dx, dz, _ = dst
            word = (W.PORTAL
                    | (1 << 4)                 # pkind: complete
                    | (prot << 6)
                    | (0 << 8)                 # behind-cell: wall
                    | (((dx - sx) + 64) << 12)
                    | (((dz - sz) + 64) << 19)
                    | (dp << 26))
            words[sp, sz * 64 + sx] = word
    spawn = (0, 4 * (S // 2) + 1, 4 * (S // 2) + 1)
    meta = dict(sectors=P * S * S, portal_pairs=len(portal_pairs),
                spawn=spawn,
                sector_centre=lambda p, i, j: (4 * j + 2, 4 * i + 2))
    return words, meta


def _portal_site(p: int, i: int, j: int, side: str):
    """Portal endpoint for sector (i,j): the wall cell adjacent to the
    middle of the chosen interior edge.  2-thick walls guarantee it has
    exactly ONE free neighbour (the sector interior), matching the
    reference's find_free_dir assumption (util.h:140-149)."""
    z0, x0 = 4 * i + 1, 4 * j + 1       # interior top-left
    if side == "N":
        return (p, x0, z0 - 1, FZP)     # free neighbour below -> +Z
    if side == "S":
        return (p, x0, z0 + 2, FZN)
    if side == "W":
        return (p, x0 - 1, z0, FXP)
    return (p, x0 + 2, z0, FXN)         # "E"


def make_portal_chain(n_pairs: int = 8) -> LevelData:
    """Stress level (BASELINE config #2): a corridor where a straight ray
    traverses `n_pairs` chained portals (plus more on each bounce)."""
    if not 1 <= n_pairs <= 11:
        raise ValueError("corridor layout fits <= 11 pairs in 64")
    row = [".", ";", "*"]
    for k in range(n_pairs):
        letter = chr(ord("A") + k)
        row += [letter, ".", letter, ";", ";"]
    row += [";", "."]
    width = len(row)
    lines = ["." * width,
             "".join(row),
             "." * width]
    text = "\n".join(lines) + "\n"
    return compile_level(text.encode())


def maze_text(lv: LevelData) -> str:
    return "\n".join("".join(chr(c) for c in row).rstrip(".")
                     for row in lv.grid)
