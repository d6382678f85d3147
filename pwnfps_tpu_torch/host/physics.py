"""Player physics: movement, collision pushback, gravity, stepped rooms
Copied from pwnfps_tpu/host/physics.py.
and player portal traversal.

Host-side float32 transliteration of the reference main loop's physics
section (main.c:188-379).  This runs per frame on a few
scalars; the device never sees it - only the resulting camera matrix.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.config import PLAYER_BBOX
from ..render.camera import mat4_identity, mat4_roty
from ..world.levelc import LevelData

F = np.float32


@dataclasses.dataclass
class Keys:
    turnleft: bool = False
    turnright: bool = False
    forward: bool = False
    back: bool = False
    left: bool = False
    right: bool = False


@dataclasses.dataclass
class PlayerState:
    cam: np.ndarray                  # [4,4] f32; rows x,y,z basis + pos
    gravity_y: np.float32 = F(0.0)

    @classmethod
    def at_spawn(cls, lv: LevelData) -> "PlayerState":
        cam = mat4_identity()
        sx, sz = lv.spawn
        cam[3, 0] = F(0.5) + F(sx)
        cam[3, 1] = F(0.5)
        cam[3, 2] = F(0.5) + F(sz)
        return cls(cam=cam)


def step_player(lv: LevelData, st: PlayerState, dt: float,
                keys: Keys) -> None:
    """One physics tick, in place (main.c:188-379)."""
    cam = st.cam
    dt = F(dt)
    bbox = F(PLAYER_BBOX)

    mat4_roty(cam, dt * F(3.0) * F(keys.turnleft - keys.turnright))

    # old cell (pre-move)
    cx1 = int(cam[3, 0])
    cz1 = int(cam[3, 2])

    vel = (cam[2, :3] * (dt * F(5.0) * F(keys.forward - keys.back))
           + cam[0, :3] * (dt * F(5.0) * F(keys.left - keys.right)))
    cam[3, :3] = cam[3, :3] + vel

    px1, py1, pz1 = cam[3, 0], cam[3, 1], cam[3, 2]
    gx1 = -1 if vel[0] < 0.0 else 1
    gz1 = -1 if vel[2] < 0.0 else 1
    bx1 = px1 + F(gx1) * bbox
    bz1 = pz1 + F(gz1) * bbox
    bcx = int(bx1)
    bcz = int(bz1)
    oldcell = lv.get_cell(cx1, cz1)

    def solid(c):
        return lv.is_solid(c, oldcell, float(py1))

    def push_x():
        cam[3, 0] = F(cx1) + F(0.5) + (F(0.5) - bbox) * F(gx1)

    def push_z():
        cam[3, 2] = F(cz1) + F(0.5) + (F(0.5) - bbox) * F(gz1)

    if cx1 != bcx and cz1 != bcz:
        solx = solid(lv.get_cell(bcx, cz1))
        solz = solid(lv.get_cell(cx1, bcz))
        solc = solid(lv.get_cell(bcx, bcz))
        if solx and solz:
            push_x()
            push_z()
        elif solx:
            push_x()
        elif solz:
            push_z()
        elif solc:
            push_z()   # reference's "quick trace" TODO resolves to z
    elif cx1 != bcx:
        if solid(lv.get_cell(bcx, bcz)):
            push_x()
    elif cz1 != bcz:
        if solid(lv.get_cell(bcx, bcz)):
            push_z()

    # gravity: velocity integration is framerate-dependent on purpose
    # (main.c:266-274 uses 3*dt^2)
    cam[3, 1] = cam[3, 1] + st.gravity_y
    st.gravity_y = st.gravity_y - F(3.0) * dt * dt
    if cam[3, 1] < F(0.4):
        cam[3, 1] = F(0.4)
        st.gravity_y = F(0.0)

    # cell transition: stepped rooms + portals (main.c:277-379)
    cx2 = int(cam[3, 0])
    cz2 = int(cam[3, 2])
    if cx1 == cx2 and cz1 == cz2:
        return
    c1 = lv.get_cell(cx1, cz1)
    c2 = lv.get_cell(cx2, cz2)
    if c1 in (ord("#"), ord("&")) and c2 == ord('"'):
        cam[3, 1] = cam[3, 1] - F(1.0)
        return
    if c1 == ord('"') and c2 in (ord("#"), ord("&")):
        cam[3, 1] = cam[3, 1] + F(1.0)
        return
    if not (ord("A") <= c2 <= ord("Z")):
        return

    pm = lv.pmap[c2 - ord("A")]
    rot = 0
    rx = cam[3, 0]
    rz = cam[3, 2]
    rcx = F(cx2)
    rcz = F(cz2)
    rvxx, rvxz = cam[0, 0], cam[0, 2]
    rvzx, rvzz = cam[2, 0], cam[2, 2]

    if pm.x2 == -1:
        pass  # reference TODO: be a wall
    elif pm.x1 == cx2 and pm.z1 == cz2:
        rx = rx + F((cx2 - cx1) + (pm.x2 - pm.x1))
        rz = rz + F((cz2 - cz1) + (pm.z2 - pm.z1))
        rcx, rcz = F(pm.x2), F(pm.z2)
        rot = (-pm.rot12) & 3
    elif pm.x2 == cx2 and pm.z2 == cz2:
        rx = rx + F((cx2 - cx1) - (pm.x2 - pm.x1))
        rz = rz + F((cz2 - cz1) - (pm.z2 - pm.z1))
        rcx, rcz = F(pm.x1), F(pm.z1)
        rot = pm.rot12 & 3
    else:
        pass  # reference TODO: be a wall

    trx, trz = rx, rz
    tvxx, tvxz = rvxx, rvxz
    tvzx, tvzz = rvzx, rvzz
    cxh = rcx + F(0.5)
    czh = rcz + F(0.5)
    if rot == 1:
        rx = cxh + (trz - czh)
        rz = czh - (trx - cxh)
        rvxx, rvxz = tvxz, -tvxx
        rvzx, rvzz = tvzz, -tvzx
    elif rot == 2:
        rx = cxh * F(2.0) - rx
        rz = czh * F(2.0) - rz
        rvxx, rvxz = -tvxx, -tvxz
        rvzx, rvzz = -tvzx, -tvzz
    elif rot == 3:
        rx = cxh - (trz - czh)
        rz = czh + (trx - cxh)
        rvxx, rvxz = -tvxz, tvxx
        rvzx, rvzz = -tvzz, tvzx

    cam[3, 0] = rx
    cam[3, 2] = rz
    cam[0, 0], cam[0, 2] = rvxx, rvxz
    cam[2, 0], cam[2, 2] = rvzx, rvzz
