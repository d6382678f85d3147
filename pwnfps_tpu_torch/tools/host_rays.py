"""Rehearse the ray kernel's body on the host CPU: write a frame's primary
rays through csrc/rays.cu's rays_group, one group of pixels after
another, and hold the seven planes bit for bit against the plain path
(render/frame.py gen_rays, pixel_seeds and the origin broadcast).

    python -m pwnfps_tpu_torch.tools.host_rays

g++ builds csrc/host/host_rays.cpp, which includes csrc/rays.cu against
csrc/host/cuda_runtime.h in place of the CUDA runtime (the _rn
arithmetic the host's IEEE operations, no fused multiply-add), into
_build/; the library takes the card's own argument (render/frame.py
ray_args).  Each case runs in fast and parity mode on a few poses of the
flagship scene's camera path, twice: into planes that start on a
16-byte boundary, and into planes one word past one, so that a width
that is a multiple of 4, whose stores are 16 bytes wide in the first
layout, takes the 4-byte stores in the second.  It proves nothing about
the card's build (nvcc, --fmad=false): tests/test_torch_cuda.py holds
that.  Each case prints whether it equals the plain path; the exit code
is 1 unless every case is equal.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import hashlib
import os
import subprocess
import sys

import torch

from .. import scene as S
from .._build import BUILD_DIR, SRC_DIR
from ..render.frame import frame_rays, ray_args

# (width, height): a multiple of neither 32 nor 8 wide, 1x1, and widths
# whose rows take 16-byte stores, with a ragged parity tile or not
SHAPES = ((203, 150), (1, 1), (320, 240), (33, 17), (36, 5))
FRAMES = (0, 3, 7)      # poses of the scene's camera path
_LIB = None


def build() -> str:
    """The host library's path, built unless an up-to-date one exists."""
    host = os.path.join(SRC_DIR, "host")
    srcs = [os.path.join(host, "host_rays.cpp"),
            os.path.join(host, "cuda_runtime.h"),
            os.path.join(SRC_DIR, "rays.cu")]
    h = hashlib.sha256()
    for p in srcs:
        with open(p, "rb") as f:
            h.update(f.read())
    out = os.path.join(BUILD_DIR, f"host_rays-{h.hexdigest()[:16]}.so")
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        subprocess.run(["g++", "-std=c++17", "-O2", "-ffp-contract=off",
                        "-fno-fast-math", "-fno-strict-aliasing",
                        "-Wno-unknown-pragmas", "-shared", "-fPIC", "-I",
                        host, "-I", SRC_DIR, srcs[0], "-o", tmp],
                       check=True)
        os.replace(tmp, out)
    return out


def lib():
    global _LIB
    if _LIB is None:
        _LIB = ctypes.CDLL(build())
        _LIB.pwnfps_host_frame_rays.argtypes = [ctypes.c_char_p]
    return _LIB


def host_rays(cfg, origin, rayb, rdx, rdy, offset: int = 0):
    """(ifrom, rays, seeds) of cfg's frame from the kernel body, as
    frame_rays returns them; the planes start `offset` words into their
    buffers."""
    n = cfg.width * cfg.height
    # rows of n + 4 words: plane i starts offset words past a 16-byte
    # boundary wherever n is a multiple of 4
    buf = torch.empty((7, n + 4), dtype=torch.float32)
    planes = buf[:, offset:offset + n]
    outs = [planes[i].data_ptr() for i in range(7)]
    if lib().pwnfps_host_frame_rays(ray_args(cfg, origin, rayb, rdx, rdy,
                                             outs)):
        raise ValueError(f"host ray kernel refused {cfg.width}x"
                         f"{cfg.height}")
    p = planes.unbind(0)
    return p[:3], p[3:6], p[6].view(torch.int32)


def equal(cfg, args, offset: int) -> bool:
    """Whether the kernel body's seven planes equal the plain path's bits
    for the camera vectors args."""
    want = frame_rays(cfg, *args, "cpu")
    got = host_rays(cfg, *args, offset)
    pairs = [*zip(got[0], want[0]), *zip(got[1], want[1]),
             (got[2], want[2])]
    return all(torch.equal(g.view(torch.int32), w.view(torch.int32))
               for g, w in pairs)


def cases():
    """(name, run) pairs: run() -> whether every pose and both layouts
    equal the plain path."""
    def case(w, h, parity):
        def run():
            sc = S.flagship_scene(w, h, "cpu")
            cfg = dataclasses.replace(sc.cfg, parity=parity)
            return all(equal(cfg, sc.frame_args(k)[:4], offset)
                       for k in FRAMES for offset in (0, 1))
        return run

    return [(f"{'parity' if p else 'fast'}_{w}x{h}", case(w, h, p))
            for w, h in SHAPES for p in (False, True)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.parse_args(argv)
    ok = True
    for name, run in cases():
        eq = run()
        ok = ok and eq
        print(f"{name}: {'equal' if eq else 'DIFFERENT'}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
