# Frozen copy of pwnfps_tpu_torch/render/camera.py (commit fea5a14) for the
# benchmark's plain reference.  It imports nothing of pwnfps_tpu_torch,
# pwnfps_tpu or jax; later changes to the program do not reach it.
"""Camera model: 3x3 basis + position, host-side float32 math.
Copied from pwnfps_tpu/render/camera.py.

Mirrors the reference mat4 camera (util.h:61-110, screen.h:31-57).
The camera lives on host (tiny per-frame state); only the four derived
vectors (origin, ray base, per-pixel x/y deltas) cross to the device.
"""

from __future__ import annotations

import numpy as np

F = np.float32


def mat4_identity() -> np.ndarray:
    return np.eye(4, dtype=np.float32)


def mat4_roty(cam: np.ndarray, ang: float) -> None:
    """In-place yaw applied to basis x/z rows (util.h:96-110)."""
    vs = F(np.sin(F(ang)))
    vc = F(np.cos(F(ang)))
    vxx, vxz = cam[0, 0], cam[0, 2]
    vzx, vzz = cam[2, 0], cam[2, 2]
    cam[0, 0] = vc * vxx + vs * vxz
    cam[0, 2] = vc * vxz - vs * vxx
    cam[2, 0] = vc * vzx + vs * vzz
    cam[2, 2] = vc * vzz - vs * vzx


def mat4_rotx(cam: np.ndarray, ang: float) -> None:
    """In-place pitch on basis y/z rows (util.h:80-94; disabled upstream)."""
    vs = F(np.sin(F(ang)))
    vc = F(np.cos(F(ang)))
    vyy, vyz = cam[1, 1], cam[1, 2]
    vzy, vzz = cam[2, 1], cam[2, 2]
    cam[1, 1] = vc * vyy + vs * vyz
    cam[1, 2] = vc * vyz - vs * vyy
    cam[2, 1] = vc * vzy + vs * vzz
    cam[2, 2] = vc * vzz - vs * vzy


def camera_vectors(cam: np.ndarray, dimx: int, dimy: int):
    """(origin, rayb, rdx, rdy) float32 [3] arrays (screen.h:42-57).

    Association matters for parity: rayb = cam.z + (1*cam.x + r*cam.y).
    """
    cam = np.asarray(cam, np.float32)
    xrat = F(-1.0)
    yrat = -(F(dimy) / F(dimx))
    xsrat = F(2.0) * xrat / F(dimx)
    ysrat = F(2.0) * yrat / F(dimy)
    bx = (-xrat) * cam[0, :3]
    by = (-yrat) * cam[1, :3]
    rayb = cam[2, :3] + (bx + by)
    rdx = xsrat * cam[0, :3]
    rdy = ysrat * cam[1, :3]
    return cam[3, :3].copy(), rayb.astype(np.float32), \
        rdx.astype(np.float32), rdy.astype(np.float32)
