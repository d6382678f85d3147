"""The flagship scene: bench.py's frame (bench.py:55-103) on the demo
level.

The default level `assets/levels/demo.txt` with the game's 14-sphere
creature centred at (3.5, 0.3, 5.5), the camera at the level's spawn
point yawing 0.07 rad per frame, and the clock advancing 0.016 s per
frame.  Shared by chip_smoke.py and the tests, so both drive the same
scene.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from pwnfps_tpu.core.approx import SseTables
from pwnfps_tpu.core.config import RenderConfig
from pwnfps_tpu.ops import worlddev as W
from pwnfps_tpu.render.camera import (camera_vectors, mat4_identity,
                                      mat4_roty)
from pwnfps_tpu.world.levelc import load_level
from pwnfps_tpu.world.objects import ObjectPool

from .ops.world import TorchWorld, world_to_torch

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

    def frame_args(self, k: int):
        """(origin, rayb, rdx, rdy, sec) of frame k of the camera path,
        float32 numpy, as bench.py builds them."""
        c = self.cam.copy()
        mat4_roty(c, 0.07 * k)
        origin, rayb, rdx, rdy = camera_vectors(c, self.cfg.width,
                                                self.cfg.height)
        return origin, rayb, rdx, rdy, np.float32(0.016 * k)


def creature_pool(n: int = len(CREATURE), at=CREATURE_AT) -> ObjectPool:
    pool = ObjectPool()
    for (x, y, z, r, b, g, rr, refl) in CREATURE[:n]:
        i = pool.obj_new()
        pool.obj_set_sphere(i, r, refl, at[0] + x, at[1] + y, at[2] + z,
                            b, g, rr)
    return pool


def flagship_scene(width: int, height: int, device="cpu",
                   n_spheres: int = len(CREATURE), **cfg_kw) -> Scene:
    """The bench frame at width x height on `device`; cfg_kw override
    RenderConfig fields (e.g. maxsteps for a small test)."""
    lv = load_level(LEVEL)
    sph = creature_pool(n_spheres).prepare_render()
    world, meta = W.build_world(lv, sph, SseTables.load())
    cfg = RenderConfig(width=width, height=height, parity=False, **cfg_kw)
    cam = mat4_identity()
    sx, sz = lv.spawn
    cam[3, :3] = (sx + 0.5, 0.5, sz + 0.5)
    return Scene(world=world, meta=meta,
                 tworld=world_to_torch(world, meta, device), cfg=cfg,
                 cam=cam)
