"""A level file and a list of spheres, built by the program (its level
compiler, object pool, world packer and device upload)."""

from __future__ import annotations

import os

from ..reference.worlds.level import spheres


def build(config: dict, root: str, device):
    """(TorchWorld, WorldMeta) of the configuration on `device`, made by
    pwnfps_tpu_torch as its scenes make them (scene._demo_scene)."""
    from pwnfps_tpu_torch.core.approx import SseTables
    from pwnfps_tpu_torch.ops import worlddev as W
    from pwnfps_tpu_torch.ops.world import world_to_torch
    from pwnfps_tpu_torch.world.levelc import load_level
    from pwnfps_tpu_torch.world.objects import ObjectPool

    lv = load_level(os.path.join(root, config["level"]))
    pool = ObjectPool()
    for (x, y, z, r, b, g, rr, refl) in spheres(config):
        pool.obj_set_sphere(pool.obj_new(), r, refl, x, y, z, b, g, rr)
    tables = SseTables.load(os.path.join(root, config["sse_tables"]))
    world, meta = W.build_world(lv, pool.prepare_render(), tables)
    return world_to_torch(world, meta, device), meta
