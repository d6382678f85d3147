"""The sector maze, built by the program (its maze generator, object
pool, paged world packer and device upload)."""

from __future__ import annotations

import os

from ..reference.worlds.sector_maze import check_spawn, spheres


def build(config: dict, root: str, device):
    """(TorchWorld, WorldMeta) of the configuration on `device`, made by
    pwnfps_tpu_torch as scene.maze_scene makes it; raises ValueError
    unless the maze spawns on the configuration's cam_page."""
    from pwnfps_tpu_torch.core.approx import SseTables
    from pwnfps_tpu_torch.ops import worlddev as W
    from pwnfps_tpu_torch.ops.world import world_to_torch
    from pwnfps_tpu_torch.world.objects import ObjectPool
    from pwnfps_tpu_torch.world.procgen import generate_sector_maze

    words, info = generate_sector_maze(seed=int(config["seed"]),
                                       pages=int(config["pages"]))
    check_spawn(config, info["spawn"])
    pool = ObjectPool()
    for (x, y, z, r, b, g, rr, refl) in spheres(config, info["spawn"]):
        pool.obj_set_sphere(pool.obj_new(), r, refl, x, y, z, b, g, rr)
    tables = SseTables.load(os.path.join(root, config["sse_tables"]))
    world, meta = W.build_world_paged(words, pool.prepare_render(),
                                      info["spawn"][0], tables)
    return world_to_torch(world, meta, device), meta
