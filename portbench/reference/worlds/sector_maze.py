"""The sector maze (BASELINE config #3) from the reference's own generator,
in plain torch: a paged world atlas, one page of 64x64 cells per 256
sectors, and spheres placed beside the spawn cell."""

from __future__ import annotations

import os

import numpy as np

from ..core.approx import SseTables
from ..ops import worlddev as W
from ..ops.world import world_to_torch
from ..render.camera import mat4_identity
from ..world.objects import ObjectPool
from ..world.procgen import generate_sector_maze
from .level import RefWorld


def spheres(config: dict, spawn: tuple) -> list[tuple]:
    """(x, y, z, r, b, g, r, reflectance) of each sphere: the config's
    offsets from the spawn cell's corner (x, 0, z), as float32 stores
    them."""
    _, sx, sz = spawn
    return [(sx + x, y, sz + z, r, b, g, rr, refl)
            for (x, y, z, r, b, g, rr, refl) in config["spheres"]]


def check_spawn(config: dict, spawn: tuple) -> None:
    """ValueError unless the maze spawns on the configuration's cam_page,
    the page every primary ray of the view traffic starts on."""
    if spawn[0] != int(config["cam_page"]):
        raise ValueError(f"the maze of seed {config['seed']} spawns on page "
                         f"{spawn[0]}, not on cam_page {config['cam_page']}")


def generate(config: dict):
    """(words [pages, 4096] int32, info) of the configuration's maze,
    checked by check_spawn."""
    words, info = generate_sector_maze(seed=int(config["seed"]),
                                       pages=int(config["pages"]))
    check_spawn(config, info["spawn"])
    return words, info


def spawn_camera(spawn: tuple) -> np.ndarray:
    """The camera at the spawn cell, eye height 0.5, facing +z."""
    _, sx, sz = spawn
    cam = mat4_identity()
    cam[3, :3] = (sx + 0.5, 0.5, sz + 0.5)
    return cam


def camera(config: dict, root: str) -> np.ndarray:
    """The configuration's camera at frame 0, from the reference's
    generator alone."""
    return spawn_camera(generate(config)[1]["spawn"])


def build(config: dict, root: str, device) -> RefWorld:
    """The configuration's world on `device`: the reference's maze, the
    spheres in object order on the spawn page, the SSE table dump under
    `root`."""
    words, info = generate(config)
    pool = ObjectPool()
    for (x, y, z, r, b, g, rr, refl) in spheres(config, info["spawn"]):
        pool.obj_set_sphere(pool.obj_new(), r, refl, x, y, z, b, g, rr)
    tables = SseTables.load(os.path.join(root, config["sse_tables"]))
    world, meta = W.build_world_paged(words, pool.prepare_render(),
                                      info["spawn"][0], tables)
    return RefWorld(tworld=world_to_torch(world, meta, device), meta=meta,
                    cam=spawn_camera(info["spawn"]))
