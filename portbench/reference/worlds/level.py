"""A world from a level file and a list of spheres, in plain torch."""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from ..core.approx import SseTables
from ..ops import worlddev as W
from ..ops.world import TorchWorld, world_to_torch
from ..render.camera import mat4_identity
from ..world.levelc import load_level
from ..world.objects import ObjectPool


@dataclasses.dataclass
class RefWorld:
    tworld: TorchWorld
    meta: W.WorldMeta
    cam: np.ndarray          # 4x4 float32 camera of the path's frame 0


def spheres(config: dict) -> list[tuple]:
    """(x, y, z, r, b, g, r, reflectance) of each sphere: the config's
    offsets from `spheres_at`, as float32 stores them."""
    at = config["spheres_at"]
    return [(at[0] + x, at[1] + y, at[2] + z, r, b, g, rr, refl)
            for (x, y, z, r, b, g, rr, refl) in config["spheres"]]


def spawn_camera(level) -> np.ndarray:
    """The camera at the level's spawn cell, eye height 0.5, facing +z."""
    cam = mat4_identity()
    sx, sz = level.spawn
    cam[3, :3] = (sx + 0.5, 0.5, sz + 0.5)
    return cam


def camera(config: dict, root: str) -> np.ndarray:
    """The configuration's camera at frame 0, from its level file alone."""
    return spawn_camera(load_level(os.path.join(root, config["level"])))


def build(config: dict, root: str, device) -> RefWorld:
    """The configuration's world on `device`: the level file and the SSE
    table dump under `root`, the spheres in object order."""
    lv = load_level(os.path.join(root, config["level"]))
    pool = ObjectPool()
    for (x, y, z, r, b, g, rr, refl) in spheres(config):
        pool.obj_set_sphere(pool.obj_new(), r, refl, x, y, z, b, g, rr)
    tables = SseTables.load(os.path.join(root, config["sse_tables"]))
    world, meta = W.build_world(lv, pool.prepare_render(), tables)
    return RefWorld(tworld=world_to_torch(world, meta, device), meta=meta,
                    cam=spawn_camera(lv))
