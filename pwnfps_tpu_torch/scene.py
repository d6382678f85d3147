"""The scenes the port drives, on the demo level.

Both use `assets/levels/demo.txt` with the game's 14-sphere creature
centred at (3.5, 0.3, 5.5) and the camera at the level's spawn point:

  * `flagship_scene`: bench.py's frame (bench.py:55-103), fast mode,
    the camera yawing 0.07 rad and the clock advancing 0.016 s per
    frame;
  * `parity_scene`: BASELINE config #1 (benchmarks/configs.py:109-162),
    parity mode at 320x240 by default, the camera yawing 0.8 rad and the
    clock advancing 0.4 s per frame.  configs.py renders it on the
    reference checkout's level.txt, which this repository does not
    hold; the demo level stands in.

Shared by chip_smoke.py and the tests, so both drive the same scenes.
Each runs on the card unless the caller asks for another device.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from .core.approx import SseTables
from .core.config import RenderConfig
from .ops import worlddev as W
from .ops.world import TorchWorld, world_to_torch
from .render.camera import camera_vectors, mat4_identity, mat4_roty
from .world.levelc import load_level
from .world.objects import ObjectPool

LEVEL = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets", "levels", "demo.txt")
CREATURE_AT = (3.5, 0.3, 5.5)

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
    sec_step: float          # clock advance per frame, s

    def frame_args(self, k: int):
        """(origin, rayb, rdx, rdy, sec) of frame k of the camera path,
        float32 numpy, as bench.py and configs.py build them."""
        c = self.cam.copy()
        mat4_roty(c, self.yaw_step * k)
        origin, rayb, rdx, rdy = camera_vectors(c, self.cfg.width,
                                                self.cfg.height)
        return origin, rayb, rdx, rdy, np.float32(self.sec_step * k)


def creature_pool(n: int = len(CREATURE), at=CREATURE_AT) -> ObjectPool:
    pool = ObjectPool()
    for (x, y, z, r, b, g, rr, refl) in CREATURE[:n]:
        i = pool.obj_new()
        pool.obj_set_sphere(i, r, refl, at[0] + x, at[1] + y, at[2] + z,
                            b, g, rr)
    return pool


def _demo_scene(device, n_spheres: int, cfg: RenderConfig,
                yaw_step: float, sec_step: float) -> Scene:
    lv = load_level(LEVEL)
    sph = creature_pool(n_spheres).prepare_render()
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
