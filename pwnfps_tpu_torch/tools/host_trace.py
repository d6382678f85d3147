"""Rehearse the parity instances' kernel body on the host CPU: trace rays
through csrc/tracer_body.cuh's trace_ray, one after another, and hold
fb and zbuf bit for bit against the plain parity tracer.

    python -m pwnfps_tpu_torch.tools.host_trace [CASE ...] [--knobs K ...]

--knobs runs each case under each set of RenderConfig measurement knobs
of KNOBS (default: none) through the parity instance the card would
launch (ops/tracer.instance): the one-knob instances and VAR_FLAGS, whose
tstep (profile) is held against the plain tracer's too; "unpacked"
writes the colour unpacked, held bit for bit against the plain C4.

g++ builds csrc/host/host_trace.cpp, which includes the kernel body
against csrc/host/cuda_runtime.h in place of the CUDA runtime (there
__fdiv_rn and __fsqrt_rn are the host's IEEE division and root), with
no fused multiply-add and no fast math, into _build/; the library takes
the card's own Args (ops/tracer.py _pack).  Every branch of the parity
step can be reached here at small cost before a change goes to the card:
the fuzz cases (scene.fuzz_rays) cross rotated portals, ramps, fog and
2-high cells with spheres in the way, at reflect 2 and 6.  It proves
nothing about the card's build (nvcc, --fmad=false, the shared-memory
path T): tests/test_torch_cuda.py holds that.  A case prints the share
of equal fb and zbuf words; the exit code is 1 unless every case is 1.0.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import hashlib
import os
import subprocess
import sys
import time

import numpy as np
import torch

from .. import scene as S
from .._build import BUILD_DIR, SRC_DIR
from ..ops import tracer
from ..render.frame import frame_rays

SEC = np.float32(0.25)
# name: (builder, arguments): a scene and the frame it traces, or the
# fuzz rays (n, seed, reflect)
CASES = {
    "fuzz_r2": ("fuzz", (20000, 1, 2)),
    "fuzz_r6": ("fuzz", (20000, 2, 6)),
    "parity_96x64": ("parity_scene", (96, 64, {}, 0)),
    "parity_96x64_f2": ("parity_scene", (96, 64, {}, 2)),
    "parity_32x24_s2": ("parity_scene", (32, 24, {"samples": 2}, 0)),
    "ptrace_32x18": ("ptrace_scene", (32, 18, {"parity": True}, 1)),
    "maze_96x54": ("maze_scene", (96, 54, {"parity": True}, 0)),
    "maze_96x54_portal": ("maze_portal", (96, 54, {"parity": True}, 0)),
    "ring_96x54": ("ring_scene", (96, 54, {"parity": True}, 0)),
    "chain_96x54": ("stress_scene", (96, 54, {"parity": True}, 0)),
    "sph64_64x36": ("spheres_scene", (64, 36, {"parity": True}, 0)),
}


# measurement knobs: RenderConfig fields ("unpacked": none, the colour
# written unpacked)
KNOBS = {"none": {}, "unpacked": {}, "nowater": {"water": False},
         "profile": {"profile": True},
         **{p: {"probe": p} for p in tracer.PROBES},
         "profile_nowater_pad64": {"profile": True, "water": False,
                                   "probe": "pad64"},
         "nowater_fire1": {"water": False, "probe": "fire1"}}


def build() -> str:
    """The host library's path, built unless an up-to-date one exists."""
    host = os.path.join(SRC_DIR, "host")
    srcs = [os.path.join(host, "host_trace.cpp"),
            os.path.join(host, "cuda_runtime.h"),
            os.path.join(SRC_DIR, "tracer_body.cuh")]
    h = hashlib.sha256()
    for p in srcs:
        with open(p, "rb") as f:
            h.update(f.read())
    out = os.path.join(BUILD_DIR, f"host_trace-{h.hexdigest()[:16]}.so")
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        subprocess.run(["g++", "-std=c++17", "-O2", "-ffp-contract=off",
                        "-fno-fast-math", "-Wno-unknown-pragmas", "-shared",
                        "-fPIC", "-I", host, "-I", SRC_DIR, srcs[0], "-o",
                        out + ".tmp"], check=True)
        os.replace(out + ".tmp", out)
    return out


def inputs(name: str):
    """(tworld, cfg, ifrom, rays, seeds, sec, page0) of a case, on the
    CPU."""
    make, arg = CASES[name]
    if make == "fuzz":
        n, seed, reflect = arg
        wt, cfg, ifrom, rays, seeds = S.fuzz_rays(n, "cpu", seed,
                                                  reflect=reflect)
        return wt, cfg, ifrom, rays, seeds, SEC, 0
    w, h, kw, k = arg
    if make == "maze_portal":
        sc = S.maze_scene(w, h, "cpu", **kw)
        sc.cam = S.portal_camera(sc)
    elif make == "spheres_scene":
        sc = S.spheres_scene(64, w, h, "cpu", **kw)
    else:
        sc = getattr(S, make)(w, h, "cpu", **kw)
    origin, rayb, rdx, rdy, sec = sc.frame_args(k)
    ifrom, rays, seeds = frame_rays(sc.cfg, origin, rayb, rdx, rdy, "cpu")
    return sc.tworld, sc.cfg, ifrom, rays, seeds, sec, sc.cfg.cam_page


def run(lib, name: str, knobs: str = "none") -> tuple[float, float]:
    """(share of equal fb words, or of equal colour words with knobs
    "unpacked", share of equal zbuf words) of a case; a profile trace's
    tstep must equal the plain tracer's (ValueError)."""
    wt, cfg, ifrom, rays, seeds, sec, page0 = inputs(name)
    cfg = dataclasses.replace(cfg, **KNOBS[knobs])
    unpacked = knobs == "unpacked"
    segs = [] if cfg.profile and cfg.samples == 1 else None
    out_p, z_p = tracer.trace_wave_plain(wt, cfg, ifrom, rays, seeds, sec,
                                         not unpacked, page0=page0,
                                         segs=segs)
    keep = [t.contiguous() for t in (*ifrom, *rays, seeds)]
    n = keep[6].numel()
    fb = torch.empty_like(keep[6])
    z = torch.empty_like(keep[0])
    col = torch.empty((4, n), dtype=torch.float32)
    tstep = torch.empty((cfg.n_waves, n), dtype=torch.int32)
    entry, _ = tracer.instance(cfg, wt.n_pages)
    args = tracer._pack(wt, cfg, n, [t.data_ptr() for t in keep],
                        (fb.data_ptr(), z.data_ptr(),
                         tstep.data_ptr() if segs is not None else 0), 0,
                        sec, page0, 0, entry,
                        col.data_ptr() if unpacked else 0)
    if lib.pwnfps_host_trace(args) != 0:
        raise ValueError(f"{name}: the host build refused the Args")
    if segs is not None and not torch.equal(
            tstep, torch.stack([o.tstep for o in segs])):
        raise ValueError(f"{name} ({knobs}): tstep != the plain tracer's")
    if unpacked:
        same = (col.view(torch.int32)
                == torch.stack(list(out_p)).view(torch.int32)).all(0)
    else:
        same = fb == out_p
    return (float(same.double().mean()),
            float((z.view(torch.int32) == z_p.view(torch.int32))
                  .double().mean()))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("cases", nargs="*", metavar="CASE",
                   help=f"one of {', '.join(CASES)} (default: all)")
    p.add_argument("--knobs", nargs="+", default=["none"],
                   choices=list(KNOBS), metavar="K",
                   help=f"one of {', '.join(KNOBS)} (default: none)")
    args = p.parse_args(argv)
    unknown = set(args.cases) - set(CASES)
    if unknown:
        p.error(f"unknown cases {sorted(unknown)}")
    lib = ctypes.CDLL(build())
    lib.pwnfps_host_trace.argtypes = [ctypes.c_char_p]
    ok = True
    for name in args.cases or list(CASES):
        for knobs in args.knobs:
            t0 = time.time()
            f, z = run(lib, name, knobs)
            ok = ok and f == z == 1.0
            print(f"{name} ({knobs}): fb equal {f:.6f}, zbuf equal "
                  f"{z:.6f} ({time.time() - t0:.1f} s)", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
