"""The scenes the port drives.

The first two use `assets/levels/demo.txt` with the game's 14-sphere
creature centred at (3.5, 0.3, 5.5) and the camera at the level's spawn
point:

  * `flagship_scene`: bench.py's frame (bench.py:55-103), fast mode,
    the camera yawing 0.07 rad and the clock advancing 0.016 s per
    frame;
  * `parity_scene`: BASELINE config #1 (benchmarks/configs.py:109-162),
    parity mode at 320x240 by default, the camera yawing 0.8 rad and the
    clock advancing 0.4 s per frame.  configs.py renders it on the
    reference checkout's level.txt, which this repository does not
    hold; the demo level stands in.

The third is BASELINE config #3 (benchmarks/configs.py:175-222):

  * `maze_scene`: the 4-page, 1024-sector maze of
    `generate_sector_maze(seed=7)`, one sphere in front of the spawn
    cell, fast mode at 1280x720 with the camera starting on the spawn
    page, yawing 0.05 rad and the clock advancing 0.016 s per frame;
    `maze_scene(..., parity=True)` is the same frame in parity mode.
    `portal_camera` gives a camera that faces a cross-page portal
    instead: from the spawn cell, few primary rays leave the spawn page.

The last two are BASELINE configs #5 and #4 as configs.py runs them
without the reference checkout: on the demo level (the level configs.py
falls back to), with the first six creature spheres (configs.py's `OPOS`,
tests/test_tracer_scalar.py:26-31) centred at (9.5, 0.3, 5.5), the
camera at the spawn point, nothing cut.  On this level that centre lies
inside the wall cell (9, 5), so no ray sees the spheres, though every
segment still tests them:

  * `ptrace_scene`: config #5 (configs.py:286-321), 1920x1080, fast
    mode (or, with parity=True, the pixel-exact parity chains), reflect=6,
    samples=4, one DoF pass, the camera yawing 0.05 rad and the clock
    advancing 0.016 s per frame (render_accumulated);
  * `multicam_scene`: config #4 (configs.py:225-283), 64 cameras at
    160x120 with no blur, camera k yawed 0.1*k rad, the clock advancing
    0.1 s per step (parallel/sharding.render_cameras).

BASELINE config #2 (benchmarks/configs.py:165-171, rendered by
`_std_render`, :79-106):

  * `stress_scene`: `make_portal_chain(10)`, a corridor through ten
    chained portal pairs, no spheres, fast mode at 1280x720, reflect=2,
    one DoF pass, the camera at (1.5, 0.5, 1.5) turned 1.5707964 rad to
    face down the chain, yawing a further 0.05 rad and the clock
    advancing 0.016 s per frame;
  * `ring_scene`: the same chain on three identical pages of a paged
    atlas, each portal leading to the next page, so that a paged frame
    can be held bit for bit against the one-page chain's.

Up to 64 spheres, the object pool's capacity (world/objects.py NS_MAX):

  * `spheres_scene`: the demo level with `sphere_grid(n)`, n small
    spheres in open cells in front of the spawn camera, fast mode (or
    parity mode) with the flagship's camera path.

A synthetic world, for holding the parity step's every branch:

  * `fuzz_rays`: the JAX package's fuzz level (tests/test_space_skip.py
    FUZZ_LEVEL, FUZZ_SPHERES: portals, one of them turning the ray,
    ramps, fog, a 2-high room with '"' links, six spheres behind
    portals, in fog and in the 2-high room) and seeded random rays
    through it, not a camera's.

The generated cave level (world/procgen.py generate_maze, the JAX
package's cellular-automata level, tests/test_procgen.py):

  * `cave_scene`: `generate_maze(seed)` with its 2-high halls, fog,
    ramps and portal pairs, no spheres, fast mode (or parity mode) at
    1920x1080 by default with one DoF pass, the camera at the level's
    spawn point, yawing 0.07 rad and the clock advancing 0.016 s per
    frame, as the flagship's.

`mesh_for` gives the device mesh the multi-device path
(parallel/sharding.py) renders these scenes on: by default one card
repeated, a virtual mesh.

Shared by chip_smoke.py and the tests, so both drive the same scenes.
Each runs on the card unless the caller asks for another device.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from .core.approx import SseTables
from .core.config import RenderConfig
from .ops import worlddev as W
from .ops.world import TorchWorld, world_to_torch
from .parallel.sharding import Mesh, make_mesh
from .render.camera import camera_vectors, mat4_identity, mat4_roty
from .ops.vec import V3
from .world.levelc import compile_level, load_level
from .world.objects import ObjectPool
from .world.procgen import (generate_maze, generate_sector_maze,
                            make_portal_chain)

LEVEL = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets", "levels", "demo.txt")
CREATURE_AT = (3.5, 0.3, 5.5)
# configs.py's sphere centre (configs.py:237, :301)
CONFIGS_AT = (9.5, 0.3, 5.5)

# the 14-sphere creature (game.lua:1-30): offset x, y, z, radius,
# colour b, g, r, reflectance
CREATURE = [(0.0, 0.0, 0.0, 0.3, 0.8, 0.8, 0.8, 0.6),
            (0.0, 0.3, 0.0, 0.1, 0.4, 0.4, 0.4, 0.2),
            (0.3, 0.0, 0.0, 0.1, 0.7, 0.7, 1.0, 0.4),
            (0.0, 0.0, 0.3, 0.1, 0.7, 1.0, 0.7, 0.4),
            (-0.3, 0.0, 0.0, 0.1, 1.0, 0.7, 0.7, 0.4),
            (0.0, 0.0, -0.3, 0.1, 0.5, 1.0, 1.0, 0.4),
            (0.3, 0.0, 0.1, 0.03, 0.4, 0.4, 0.4, 0.2),
            (0.1, 0.0, 0.3, 0.03, 0.4, 0.4, 0.4, 0.2),
            (-0.3, 0.0, 0.1, 0.03, 0.4, 0.4, 0.4, 0.2),
            (0.1, 0.0, -0.3, 0.03, 0.4, 0.4, 0.4, 0.2),
            (0.3, 0.0, -0.1, 0.03, 0.4, 0.4, 0.4, 0.2),
            (-0.1, 0.0, 0.3, 0.03, 0.4, 0.4, 0.4, 0.2),
            (-0.3, 0.0, -0.1, 0.03, 0.4, 0.4, 0.4, 0.2),
            (-0.1, 0.0, -0.3, 0.03, 0.4, 0.4, 0.4, 0.2)]


@dataclasses.dataclass
class Scene:
    world: W.WorldDev        # numpy world (the JAX package's input)
    meta: W.WorldMeta
    tworld: TorchWorld       # the same world as tensors on the device
    cfg: RenderConfig
    cam: np.ndarray          # 4x4 camera at frame 0
    yaw_step: float          # camera yaw per frame, rad
    sec_step: float          # clock advance per frame (or step), s
    cams: np.ndarray | None = None   # [C, 4, 4] camera batch, if any

    def frame_args(self, k: int):
        """(origin, rayb, rdx, rdy, sec) of frame k of the camera path,
        float32 numpy, as bench.py and configs.py build them."""
        c = self.cam.copy()
        mat4_roty(c, self.yaw_step * k)
        origin, rayb, rdx, rdy = camera_vectors(c, self.cfg.width,
                                                self.cfg.height)
        return origin, rayb, rdx, rdy, np.float32(self.sec_step * k)

    def step_args(self, k: int):
        """(cams [C, 4, 4] float32, sec) of step k of a camera batch, as
        configs.py:267-274 steps it: fixed cameras, the clock moving."""
        return self.cams, np.float32(self.sec_step * k)


def creature_pool(n: int = len(CREATURE), at=CREATURE_AT) -> ObjectPool:
    pool = ObjectPool()
    for (x, y, z, r, b, g, rr, refl) in CREATURE[:n]:
        i = pool.obj_new()
        pool.obj_set_sphere(i, r, refl, at[0] + x, at[1] + y, at[2] + z,
                            b, g, rr)
    return pool


def _demo_scene(device, pool: ObjectPool, cfg: RenderConfig,
                yaw_step: float, sec_step: float) -> Scene:
    lv = load_level(LEVEL)
    world, meta = W.build_world(lv, pool.prepare_render(), SseTables.load())
    cam = mat4_identity()
    sx, sz = lv.spawn
    cam[3, :3] = (sx + 0.5, 0.5, sz + 0.5)
    return Scene(world=world, meta=meta,
                 tworld=world_to_torch(world, meta, device), cfg=cfg,
                 cam=cam, yaw_step=yaw_step, sec_step=sec_step)


def flagship_scene(width: int, height: int, device="cuda",
                   n_spheres: int = len(CREATURE), **cfg_kw) -> Scene:
    """The bench frame at width x height on `device`; cfg_kw override
    RenderConfig fields (e.g. maxsteps for a small test)."""
    cfg = RenderConfig(width=width, height=height, parity=False, **cfg_kw)
    return _demo_scene(device, creature_pool(n_spheres), cfg, 0.07, 0.016)


def parity_scene(width: int = 320, height: int = 240, device="cuda",
                 n_spheres: int = len(CREATURE), **cfg_kw) -> Scene:
    """BASELINE config #1's frame (configs.py:128: parity, reflect=2,
    one DoF pass) on the demo level, at width x height on `device`."""
    cfg = RenderConfig(width=width, height=height, parity=True, **cfg_kw)
    return _demo_scene(device, creature_pool(n_spheres), cfg, 0.8, 0.4)


def ptrace_scene(width: int = 1920, height: int = 1080, device="cuda",
                 parity: bool = False, **cfg_kw) -> Scene:
    """BASELINE config #5's frame (configs.py:286-321: reflect=6,
    samples=4, one DoF pass) at width x height on `device`, in fast mode
    or, with parity=True, in parity mode; cfg_kw override RenderConfig
    fields.  Render it with render_accumulated (samples=cfg.samples)."""
    kw = {"reflect": 6, "samples": 4, "postproc_blur": 1, **cfg_kw}
    cfg = RenderConfig(width=width, height=height, parity=parity, **kw)
    return _demo_scene(device, creature_pool(6, CONFIGS_AT), cfg, 0.05,
                       0.016)


def sphere_grid(n: int = 64) -> list[tuple]:
    """n spheres (x, y, z, r, b, g, r, reflectance) of radius 0.05 in
    open cells of the demo level in front of its spawn point: sphere k
    < 20 at (2.5 + k%5, 0.3, 3.5 + k//5), then, 20 a layer, the same 5x4
    cells at y 0.7 and at (+0.25, 0.5, +0.25), and the last four in
    column x 1.5.  Their colours and reflectances differ from one sphere
    to the next, so that a wrong sphere index changes a pixel."""
    out = []
    for k in range(n):
        layer, j = divmod(k, 20)
        if layer < 3:
            dx, y, dz = ((0.0, 0.3, 0.0), (0.0, 0.7, 0.0),
                         (0.25, 0.5, 0.25))[layer]
            x, z = 2.5 + j % 5 + dx, 3.5 + j // 5 + dz
        else:
            x, y, z = 1.5, 0.3, 3.5 + j
        out.append((x, y, z, 0.05, 0.2 + 0.8 * (k % 7) / 6,
                    0.2 + 0.8 * (k % 5) / 4, 0.2 + 0.8 * (k % 3) / 2,
                    0.1 + 0.1 * (k % 6)))
    return out


def spheres_scene(n_spheres: int = 64, width: int = 32, height: int = 24,
                  device="cuda", **cfg_kw) -> Scene:
    """The demo level with sphere_grid(n_spheres) at width x height on
    `device`, the flagship's camera path; cfg_kw override RenderConfig
    fields (parity=True: parity mode)."""
    pool = ObjectPool()
    for (x, y, z, r, b, g, rr, refl) in sphere_grid(n_spheres):
        pool.obj_set_sphere(pool.obj_new(), r, refl, x, y, z, b, g, rr)
    cfg = RenderConfig(width=width, height=height,
                       **{"parity": False, **cfg_kw})
    return _demo_scene(device, pool, cfg, 0.07, 0.016)


def multicam_scene(device="cuda", n_cams: int = 64, **cfg_kw) -> Scene:
    """BASELINE config #4 (configs.py:225-283): n_cams cameras at the
    spawn point, camera k yawed 0.1*k rad, 160x120, no blur, on `device`;
    cfg_kw override RenderConfig fields (width and height included).
    Step it with step_args and render_cameras."""
    kw = {"width": 160, "height": 120, "postproc_blur": 0, **cfg_kw}
    sc = _demo_scene(device, creature_pool(6, CONFIGS_AT),
                     RenderConfig(parity=False, **kw), 0.0, 0.1)
    cams = []
    for k in range(n_cams):
        c = sc.cam.copy()
        mat4_roty(c, 0.1 * k)
        cams.append(c)
    sc.cams = np.stack(cams).astype(np.float32)
    return sc


def cave_scene(seed: int = 11, width: int = 1920, height: int = 1080,
               device="cuda", parity: bool = False, **cfg_kw) -> Scene:
    """generate_maze(seed) (its cave smoothing on `device`), no spheres,
    at width x height on `device` from its spawn point, in fast mode or,
    with parity=True, parity mode; cfg_kw override RenderConfig fields."""
    lv = generate_maze(seed, device=device)
    world, meta = W.build_world(lv, ObjectPool().prepare_render(),
                                SseTables.load())
    cfg = RenderConfig(width=width, height=height, parity=parity, **cfg_kw)
    cam = mat4_identity()
    sx, sz = lv.spawn
    cam[3, :3] = (sx + 0.5, 0.5, sz + 0.5)
    return Scene(world=world, meta=meta,
                 tworld=world_to_torch(world, meta, device), cfg=cfg,
                 cam=cam, yaw_step=0.07, sec_step=0.016)


def stress_scene(width: int = 1280, height: int = 720, device="cuda",
                 **cfg_kw) -> Scene:
    """BASELINE config #2's frame (configs.py:165-171 through
    _std_render, :79-106: the portal chain of ten pairs, no spheres, fast
    mode, reflect=2, one DoF pass) at width x height on `device`; cfg_kw
    override RenderConfig fields."""
    lv = make_portal_chain(10)
    world, meta = W.build_world(lv, ObjectPool().prepare_render(),
                                SseTables.load())
    return _chain_scene(world, meta, width, height, device, cfg_kw)


def _chain_scene(world, meta, width, height, device, cfg_kw) -> Scene:
    cfg = RenderConfig(width=width, height=height,
                       **{"parity": False, **cfg_kw})
    cam = mat4_identity()
    cam[3, :3] = (1.5, 0.5, 1.5)
    mat4_roty(cam, 1.5707964)            # face down the chain (+x)
    return Scene(world=world, meta=meta,
                 tworld=world_to_torch(world, meta, device), cfg=cfg,
                 cam=cam, yaw_step=0.05, sec_step=0.016)


def with_dpage(words: np.ndarray, page: int) -> np.ndarray:
    """A copy of one page's static words with every portal's target page
    set to `page` (word bits 26-29)."""
    out = np.array(words, np.int32)
    out[(out & 0xF) == W.PORTAL] |= np.int32(page << 26)
    return out


def ring_scene(width: int = 1280, height: int = 720, device="cuda",
               **cfg_kw) -> Scene:
    """`stress_scene`'s portal chain on three identical pages of a paged
    atlas, every portal of page p leading to page (p + 1) % 3, the camera
    on page 0: each portal a ray crosses moves it to the next page, and
    its frame is the one-page chain's bit for bit.  The same camera path
    and cfg_kw as stress_scene."""
    chain = W.pack_static_word(make_portal_chain(10))
    words = np.stack([with_dpage(chain, (p + 1) % 3) for p in range(3)])
    world, meta = W.build_world_paged(words, ObjectPool().prepare_render(),
                                      0, SseTables.load())
    return _chain_scene(world, meta, width, height, device, cfg_kw)


def maze_scene(width: int = 1280, height: int = 720, device="cuda",
               seed: int = 7, pages: int = 4, view: str = "path",
               **cfg_kw) -> Scene:
    """BASELINE config #3's frame (configs.py:175-222: the paged sector
    maze, one sphere of radius 0.25 and reflectance 0.5 on the spawn
    page, fast mode with the empty-space skip) at width x height on
    `device`; pages: the atlas's pages (config #3 has 4); view: "path",
    config #3's camera at the spawn point, or "portal", the camera
    facing the first cross-page portal (portal_camera); cfg_kw override
    RenderConfig fields (parity=True: the same world and camera in
    parity mode)."""
    if view not in ("path", "portal"):
        raise ValueError(f"unknown maze view {view!r}")
    words, info = generate_sector_maze(seed=seed, pages=pages)
    sp, sx, sz = info["spawn"]
    pool = ObjectPool()
    i = pool.obj_new()
    pool.obj_set_sphere(i, 0.25, 0.5, sx + 0.5, 0.35, sz + 1.2,
                        0.9, 0.6, 0.6)
    world, meta = W.build_world_paged(words, pool.prepare_render(), sp,
                                      SseTables.load())
    cfg = RenderConfig(width=width, height=height,
                       **{"parity": False, "cam_page": sp, **cfg_kw})
    cam = mat4_identity()
    cam[3, :3] = (sx + 0.5, 0.5, sz + 0.5)
    sc = Scene(world=world, meta=meta,
               tworld=world_to_torch(world, meta, device), cfg=cfg,
               cam=cam, yaw_step=0.05, sec_step=0.016)
    if view == "portal":
        sc.cam = portal_camera(sc)
    return sc


def cross_page_portals(world: W.WorldDev, page: int):
    """(x, z, dpage, dx, dz) of each portal cell on `page` of a paged
    world whose target page differs, with (dx, dz) the step to its one
    open neighbour."""
    g = np.asarray(world.word).reshape(-1, 64, 64)[page]
    out = []
    for z, x in np.argwhere((g & 0xF) == W.PORTAL):
        dp = int(W.w_dpage(int(g[z, x])))
        nb = [(dx, dz) for dx, dz in ((1, 0), (-1, 0), (0, 1), (0, -1))
              if 0 <= x + dx < 64 and 0 <= z + dz < 64
              and (g[z + dz, x + dx] & 0xF) == W.FLOOR]
        if dp != page and len(nb) == 1:
            out.append((int(x), int(z), dp) + nb[0])
    return out


def portal_camera(sc: Scene) -> np.ndarray:
    """A 4x4 camera in the open cell beside the first cross-page portal
    on the scene's camera page, facing the portal: 0.13 off the cell
    centre across the portal's axis and turned 0.1 rad off it, so that
    the symmetric pixel grid does not aim rays exactly at cell edges."""
    x, z, _, dx, dz = cross_page_portals(sc.world, sc.cfg.cam_page)[0]
    cam = mat4_identity()
    cam[3, :3] = (x + dx + 0.5 + 0.13 * dz, 0.5, z + dz + 0.5 + 0.13 * dx)
    mat4_roty(cam, float(np.arctan2(-dx, -dz)) + 0.1)
    return cam


def mesh_for(n_cam: int, n_px: int, device="cuda",
             distinct: bool = False) -> Mesh:
    """An (n_cam, n_px) mesh of `device` repeated n_cam * n_px times, or,
    with distinct=True on a machine with that many cards, of cards 0 ..
    n_cam * n_px - 1."""
    n = n_cam * n_px
    if distinct and torch.device(device).type == "cuda" \
            and torch.cuda.device_count() >= n:
        return make_mesh(n_cam, n_px, [torch.device("cuda", i)
                                       for i in range(n)])
    return make_mesh(n_cam, n_px, [device] * n)


# the fuzz level (tests/test_space_skip.py), its spheres (x, y, z,
# radius), and the points the fuzz rays start near
FUZZ_LEVEL = b"""................
.;;;;;;;;;;;;;;.
.;A;;;;;;;;;;A;.
.;;;$$$;;;;;;;;.
.;;;$$$;;B;;;;;.
.;;;$$$;;;;;;;;.
.;;;;;>;;;##\x22#.
.;;B;;;;;;##&#.
.;;;;;,;;;####.
.;;;;;;;;;;;;;.
................
"""
FUZZ_SPHERES = [(2.5, 0.4, 2.6, 0.25), (12.2, 0.5, 2.4, 0.2),
                (6.5, 0.45, 7.5, 0.3), (11.5, 1.4, 7.2, 0.2),
                (5.5, 0.5, 4.5, 0.35), (9.6, 0.4, 4.4, 0.15)]
FUZZ_BASES = [(2.5, 0.5, 2.5), (5.0, 0.5, 4.5), (6.5, 0.5, 6.5),
              (11.5, 0.5, 7.5), (12.5, 0.5, 2.5), (11.5, 1.5, 7.0),
              (1.5, 0.5, 8.5), (8.5, 0.5, 1.5), (6.5, 0.5, 7.5),
              (6.5, 0.5, 8.5)]


def fuzz_rays(n: int, device="cuda", seed: int = 1, **cfg_kw):
    """The fuzz level with its six spheres on `device`, in parity mode
    with maxsteps 200 (cfg_kw override RenderConfig fields), and n rays
    from `seed`: ray k starts within 0.45 of FUZZ_BASES[k % 10] (-0.4 to
    0.45 in y) in a uniform direction whose Y component is scaled by
    U(0.05, 1).  Returns (tworld, cfg, ifrom V3, rays V3, seeds int32
    [n])."""
    pool = ObjectPool()
    for (x, y, z, r) in FUZZ_SPHERES:
        i = pool.obj_new()
        pool.obj_set_sphere(i, r, 0.4, x, y, z, 0.8, 0.7, 0.9)
    world, meta = W.build_world(compile_level(FUZZ_LEVEL),
                                pool.prepare_render(), SseTables.load())
    rng = np.random.default_rng(seed)
    base = np.array(FUZZ_BASES, np.float32)[np.arange(n) % len(FUZZ_BASES)]
    froms = (base + rng.uniform((-0.45, -0.4, -0.45), (0.45, 0.45, 0.45),
                                (n, 3))).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:, 1] *= rng.uniform(0.05, 1.0, n)
    dirs = d.astype(np.float32)
    seeds = rng.integers(0, 2 ** 31, n).astype(np.int32)
    cfg = RenderConfig(**{"parity": True, "maxsteps": 200, **cfg_kw})

    def col(a, i):
        return torch.from_numpy(np.ascontiguousarray(a[:, i])).to(device)
    return (world_to_torch(world, meta, device), cfg,
            V3(*(col(froms, i) for i in range(3))),
            V3(*(col(dirs, i) for i in range(3))),
            torch.from_numpy(seeds).to(device))
