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
    page, yawing 0.05 rad and the clock advancing 0.016 s per frame.
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
    advancing 0.016 s per frame.

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
from .world.levelc import load_level
from .world.objects import ObjectPool
from .world.procgen import generate_sector_maze, make_portal_chain

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


def _demo_scene(device, n_spheres: int, cfg: RenderConfig,
                yaw_step: float, sec_step: float,
                at=CREATURE_AT) -> Scene:
    lv = load_level(LEVEL)
    sph = creature_pool(n_spheres, at).prepare_render()
    world, meta = W.build_world(lv, sph, SseTables.load())
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
    return _demo_scene(device, n_spheres, cfg, 0.07, 0.016)


def parity_scene(width: int = 320, height: int = 240, device="cuda",
                 n_spheres: int = len(CREATURE), **cfg_kw) -> Scene:
    """BASELINE config #1's frame (configs.py:128: parity, reflect=2,
    one DoF pass) on the demo level, at width x height on `device`."""
    cfg = RenderConfig(width=width, height=height, parity=True, **cfg_kw)
    return _demo_scene(device, n_spheres, cfg, 0.8, 0.4)


def ptrace_scene(width: int = 1920, height: int = 1080, device="cuda",
                 parity: bool = False, **cfg_kw) -> Scene:
    """BASELINE config #5's frame (configs.py:286-321: reflect=6,
    samples=4, one DoF pass) at width x height on `device`, in fast mode
    or, with parity=True, in parity mode; cfg_kw override RenderConfig
    fields.  Render it with render_accumulated (samples=cfg.samples)."""
    kw = {"reflect": 6, "samples": 4, "postproc_blur": 1, **cfg_kw}
    cfg = RenderConfig(width=width, height=height, parity=parity, **kw)
    return _demo_scene(device, 6, cfg, 0.05, 0.016, CONFIGS_AT)


def multicam_scene(device="cuda", n_cams: int = 64, **cfg_kw) -> Scene:
    """BASELINE config #4 (configs.py:225-283): n_cams cameras at the
    spawn point, camera k yawed 0.1*k rad, 160x120, no blur, on `device`;
    cfg_kw override RenderConfig fields (width and height included).
    Step it with step_args and render_cameras."""
    kw = {"width": 160, "height": 120, "postproc_blur": 0, **cfg_kw}
    sc = _demo_scene(device, 6, RenderConfig(parity=False, **kw), 0.0, 0.1,
                     CONFIGS_AT)
    cams = []
    for k in range(n_cams):
        c = sc.cam.copy()
        mat4_roty(c, 0.1 * k)
        cams.append(c)
    sc.cams = np.stack(cams).astype(np.float32)
    return sc


def stress_scene(width: int = 1280, height: int = 720, device="cuda",
                 **cfg_kw) -> Scene:
    """BASELINE config #2's frame (configs.py:165-171 through
    _std_render, :79-106: the portal chain of ten pairs, no spheres, fast
    mode, reflect=2, one DoF pass) at width x height on `device`; cfg_kw
    override RenderConfig fields."""
    lv = make_portal_chain(10)
    world, meta = W.build_world(lv, ObjectPool().prepare_render(),
                                SseTables.load())
    cfg = RenderConfig(width=width, height=height, parity=False, **cfg_kw)
    cam = mat4_identity()
    cam[3, :3] = (1.5, 0.5, 1.5)
    mat4_roty(cam, 1.5707964)            # face down the chain (+x)
    return Scene(world=world, meta=meta,
                 tworld=world_to_torch(world, meta, device), cfg=cfg,
                 cam=cam, yaw_step=0.05, sec_step=0.016)


def maze_scene(width: int = 1280, height: int = 720, device="cuda",
               seed: int = 7, **cfg_kw) -> Scene:
    """BASELINE config #3's frame (configs.py:175-222: the paged sector
    maze, one sphere of radius 0.25 and reflectance 0.5 on the spawn
    page, fast mode with the empty-space skip) at width x height on
    `device`; cfg_kw override RenderConfig fields."""
    words, info = generate_sector_maze(seed=seed)
    sp, sx, sz = info["spawn"]
    pool = ObjectPool()
    i = pool.obj_new()
    pool.obj_set_sphere(i, 0.25, 0.5, sx + 0.5, 0.35, sz + 1.2,
                        0.9, 0.6, 0.6)
    world, meta = W.build_world_paged(words, pool.prepare_render(), sp,
                                      SseTables.load())
    cfg = RenderConfig(width=width, height=height, parity=False,
                       cam_page=sp, **cfg_kw)
    cam = mat4_identity()
    cam[3, :3] = (sx + 0.5, 0.5, sz + 0.5)
    return Scene(world=world, meta=meta,
                 tworld=world_to_torch(world, meta, device), cfg=cfg,
                 cam=cam, yaw_step=0.05, sec_step=0.016)


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
