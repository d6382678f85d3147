"""Procedural worlds (BASELINE configs #3 and #2).
Copied from pwnfps_tpu/world/procgen.py (`_cave_grid`, `generate_maze`,
`generate_sector_maze`, `_portal_site`, `make_portal_chain` and
`maze_text`).

`generate_maze` is the cellular-automata cave level: a 64x64 grid of
uniform draws, smoothed, its largest open component decorated with
2-high halls, fog pockets, ramps and up to 26 portal pairs.  The JAX
package draws the grid with `jax.random`; `_cave_grid` reproduces those
bits without it (`_threefry_uniform`).

The sector maze is a multi-page world atlas: pages of 16 x 16 sectors,
each a 2x2 interior behind 2-thick walls, linked by carved doorways
within a page and by portals across pages, plus random teleport pairs.
The portal chain is a one-page corridor of chained portal pairs.
"""

from __future__ import annotations

import numpy as np

import torch

from ..core.config import FXN, FXP, FZN, FZP
from ..ops import worlddev as W
from .cells import celltype_is_free
from .levelc import LevelData, compile_level

# Threefry-2x32's rotation amounts, two groups of four rounds, and the
# key schedule's parity constant (Salmon et al. 2011; jax's
# threefry2x32)
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _threefry2x32(k0: int, k1: int, x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32 with 20 rounds of the counters (x0, x1), uint32
    arrays, under the key (k0, k1): its two output words."""
    ks = [np.uint32(k0), np.uint32(k1),
          np.uint32(k0 ^ k1 ^ _PARITY)]
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = x0 + x1
            x1 = (x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))
            x1 = x1 ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def _threefry_uniform(seed: int, shape: tuple) -> np.ndarray:
    """The bits of jax.random.uniform(jax.random.PRNGKey(seed), shape)
    (f32, [0, 1)) under jax's default 32-bit mode with
    jax_threefry_partitionable on (jax 0.9.0's default): the key is (0,
    seed mod 2^32) - 32-bit mode keeps only the seed's low word - and
    element i, in row-major order, takes the xor of the two Threefry-2x32
    words of the counter pair (i >> 32, i mod 2^32).  Its top 23 bits
    become the mantissa of a float in [1, 2), from which 1.0 is
    subtracted."""
    n = int(np.prod(shape))
    idx = np.arange(n, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b0, b1 = _threefry2x32(0, seed & 0xFFFFFFFF, hi, lo)
    f = ((b0 ^ b1) >> np.uint32(9)) | np.uint32(0x3F800000)
    u = f.view(np.float32) - np.float32(1.0)
    return np.maximum(np.float32(0.0), u).reshape(shape)


def _cave_grid(seed: int, density: float, iters: int,
               device="cuda") -> np.ndarray:
    """Cellular-automata cave: True = open (procgen.py:21-44).  The
    uniform draws are jax.random.uniform's (`_threefry_uniform`); the
    iters smoothing passes run as int32 torch ops on `device`, each cell
    open where its 8 neighbours (wrapping round the grid) plus twice
    itself reach 5; the border is then closed."""
    u = torch.from_numpy(_threefry_uniform(seed, (64, 64))).to(device)
    g = u > np.float32(density)
    for _ in range(iters):
        gi = g.to(torch.int32)
        up, dn = torch.roll(gi, 1, 0), torch.roll(gi, -1, 0)
        n = (up + dn + torch.roll(gi, 1, 1) + torch.roll(gi, -1, 1)
             + torch.roll(up, 1, 1) + torch.roll(up, -1, 1)
             + torch.roll(dn, 1, 1) + torch.roll(dn, -1, 1))
        g = (n + gi * 2) >= 5
    g[0, :] = False
    g[-1, :] = False
    g[:, 0] = False
    g[:, -1] = False
    return g.cpu().numpy()


def generate_maze(seed: int = 0, density: float = 0.44,
                  n_portals: int = 26, fog: bool = True,
                  tall: bool = True, ramps: bool = True,
                  lowercase: int = 4, device="cuda") -> LevelData:
    """Build a procedural level; returns the compiled LevelData
    (procgen.py:47-153).  The cave's smoothing runs on `device`."""
    rng = np.random.default_rng(seed)
    open_ = _cave_grid(seed, density, iters=4, device=device)

    # keep only the largest connected open component (flood fill)
    from collections import deque
    best, bestn = None, 0
    seen = np.zeros_like(open_, bool)
    for z in range(64):
        for x in range(64):
            if open_[z, x] and not seen[z, x]:
                comp = []
                dq = deque([(z, x)])
                seen[z, x] = True
                while dq:
                    cz, cx = dq.popleft()
                    comp.append((cz, cx))
                    for dz, dx in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                        nz, nx = cz + dz, cx + dx
                        if (0 <= nz < 64 and 0 <= nx < 64
                                and open_[nz, nx] and not seen[nz, nx]):
                            seen[nz, nx] = True
                            dq.append((nz, nx))
                if len(comp) > bestn:
                    best, bestn = comp, len(comp)
    grid = np.full((64, 64), ord("."), np.uint8)
    for z, x in best:
        grid[z, x] = ord(";")

    cells = np.array(best)

    def region(char, count, size):
        for _ in range(count):
            cz, cx = cells[rng.integers(len(cells))]
            for dz in range(-size, size + 1):
                for dx in range(-size, size + 1):
                    z, x = cz + dz, cx + dx
                    if 1 <= z <= 62 and 1 <= x <= 62 \
                            and grid[z, x] == ord(";"):
                        grid[z, x] = ord(char)

    if tall:
        region("#", 6, 2)
    if fog:
        region("$", 5, 2)
    if ramps:
        # ramps only where both sides stay walkable
        for _ in range(12):
            cz, cx = cells[rng.integers(len(cells))]
            c = rng.choice([">", "<", ",", "^"])
            if grid[cz, cx] == ord(";"):
                grid[cz, cx] = ord(c)

    # portals: straight wall cells with exactly one free 4-neighbour
    sites = []
    for z in range(2, 62):
        for x in range(2, 62):
            if grid[z, x] != ord("."):
                continue
            free = [celltype_is_free(int(grid[z + dz, x + dx]))
                    for dz, dx in ((0, 1), (1, 0), (0, -1), (-1, 0))]
            if sum(free) == 1:
                sites.append((z, x))
    rng.shuffle(sites)
    placed = 0
    next_letter = 0
    used = np.zeros((64, 64), bool)
    for (z1, x1) in sites:
        if placed >= n_portals or next_letter >= 26:
            break
        if used[max(z1 - 1, 0):z1 + 2, max(x1 - 1, 0):x1 + 2].any():
            continue
        for (z2, x2) in sites[::-1]:
            if (z2, x2) == (z1, x1) or used[z2, x2] \
                    or abs(z2 - z1) + abs(x2 - x1) < 8:
                continue
            if used[max(z2 - 1, 0):z2 + 2, max(x2 - 1, 0):x2 + 2].any():
                continue
            alias = placed < lowercase and next_letter + 1 < 26 \
                and next_letter < 24  # 'y' is the last aliasable letter
            if alias:
                # lowercase endpoint rewrites to the NEXT letter and
                # registers under both slots (level.h:144-178): the pair
                # works via this slot, but the written cell displays the
                # next letter whose slot stays half-open -> one-way
                # portal. The next letter is consumed.
                grid[z1, x1] = ord("a") + next_letter
                grid[z2, x2] = ord("A") + next_letter
                next_letter += 2
            else:
                grid[z1, x1] = ord("A") + next_letter
                grid[z2, x2] = ord("A") + next_letter
                next_letter += 1
            used[z1, x1] = used[z2, x2] = True
            placed += 1
            break

    # spawn: first open cell of the main component
    sz, sx = best[len(best) // 2]
    grid[sz, sx] = ord("*")

    text = b"\n".join(bytes(grid[z]).rstrip(b".") or b"." for z in
                      range(64)) + b"\n"
    lv = compile_level(text)
    return lv


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
