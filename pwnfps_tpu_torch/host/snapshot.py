"""Checkpoint/resume of the complete game state.
Copied from pwnfps_tpu/host/snapshot.py.

The reference has no persistence; its entire mutable state is tiny
(camera mat4, gravity, clock, the object pool, script variables -
SURVEY.md section 5).  Snapshotting it enables deterministic replay for
parity tests and crash-resume for long-running sessions.
"""

from __future__ import annotations

import json

import numpy as np

from ..world.objects import ObjectPool
from .physics import PlayerState


def save_state(path: str, player: PlayerState, pool: ObjectPool,
               sec: float, extra: dict | None = None) -> None:
    np.savez(
        path,
        cam=player.cam,
        gravity_y=np.float32(player.gravity_y),
        sec=np.float32(sec),
        objs_num=np.int64(pool.objs_num),
        typ=pool.typ[:pool.objs_num],
        r=pool.r[:pool.objs_num],
        refl=pool.refl[:pool.objs_num],
        pos=pool.pos[:pool.objs_num],
        col=pool.col[:pool.objs_num],
        extra=np.frombuffer(
            json.dumps(extra or {}).encode(), dtype=np.uint8),
    )


def load_state(path: str) -> tuple[PlayerState, ObjectPool, float, dict]:
    z = np.load(path)
    player = PlayerState(cam=np.array(z["cam"], np.float32),
                         gravity_y=np.float32(z["gravity_y"]))
    pool = ObjectPool()
    n = int(z["objs_num"])
    pool.objs_num = n
    pool.typ[:n] = z["typ"]
    pool.r[:n] = z["r"]
    pool.refl[:n] = z["refl"]
    pool.pos[:n] = z["pos"]
    pool.col[:n] = z["col"]
    extra = json.loads(bytes(z["extra"]).decode() or "{}")
    return player, pool, float(z["sec"]), extra
