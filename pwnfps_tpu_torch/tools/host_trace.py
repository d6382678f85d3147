"""Rehearse the tracer kernel's body on the host CPU: trace rays through
csrc/tracer_body.cuh's trace_ray, one after another, in either mode, and
hold fb, zbuf and (profile) the per-wave step counts bit for bit against
the plain tracer.

    python -m pwnfps_tpu_torch.tools.host_trace [CASE ...] [--knobs K ...]

--knobs runs each case under each set of RenderConfig measurement knobs
of KNOBS (default: none) through the instance the card would launch
(ops/tracer.instance): the one-knob instances and VAR_FLAGS, whose tstep
(profile) is held against the plain tracer's too; "unpacked" writes the
colour unpacked, held bit for bit against the plain C4.

g++ builds csrc/host/host_trace.cpp, which includes the kernel body
against csrc/host/cuda_runtime.h in place of the CUDA runtime (there
__fdiv_rn and __fsqrt_rn are the host's IEEE division and root), with
no fused multiply-add and no fast math, into _build/; the library takes
the card's own Args (ops/tracer.py _pack).  Parity mode calls no math
library, so the host build equals the plain parity tracer as it is.
Fast mode calls rsqrtf, sqrtf, sinf, cosf and expf, which on the host
are the C library's and in the plain tracer torch's (torch's CPU sqrt
and rsqrt are not always correctly rounded): a fast case plugs the host
library's five functions into the plain tracer (`host_math`), so that
every other operation is held bit for bit.

Every branch of the DDA step can be reached here at small cost before a
change goes to the card: the fuzz cases (scene.fuzz_rays) cross rotated
portals, ramps, fog and 2-high cells with spheres in the way, at reflect
2 and 6, in both modes, and the maze cases change page.  It proves
nothing about the card's build (nvcc, --fmad=false, the shared-memory
path T): tests/test_torch_cuda.py holds that.  A case prints the share of
equal fb and zbuf words; the exit code is 1 unless every case is 1.0.
"""

from __future__ import annotations

import argparse
import contextlib
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
from ..ops import tracer, tracer_core
from ..render.frame import frame_rays

SEC = np.float32(0.25)
# name: (builder, arguments): a scene, its size, RenderConfig fields and
# the frame it traces, or the fuzz rays (n, seed, fuzz_rays's fields);
# parity mode where the fields set parity (the fuzz rays' default), else
# fast mode
CASES = {
    "fuzz_r2": ("fuzz", (20000, 1, {"reflect": 2})),
    "fuzz_r6": ("fuzz", (20000, 2, {"reflect": 6})),
    "parity_96x64": ("parity_scene", (96, 64, {}, 0)),
    "parity_96x64_f2": ("parity_scene", (96, 64, {}, 2)),
    "parity_32x24_s2": ("parity_scene", (32, 24, {"samples": 2}, 0)),
    "ptrace_32x18": ("ptrace_scene", (32, 18, {"parity": True}, 1)),
    "maze_96x54": ("maze_scene", (96, 54, {"parity": True}, 0)),
    "maze_96x54_portal": ("maze_scene", (96, 54, {"parity": True,
                                                  "view": "portal"}, 0)),
    "ring_96x54": ("ring_scene", (96, 54, {"parity": True}, 0)),
    "chain_96x54": ("stress_scene", (96, 54, {"parity": True}, 0)),
    "sph64_64x36": ("spheres_scene", (64, 36, {"parity": True}, 0)),
    "fast_fuzz_r2": ("fuzz", (20000, 1, {"reflect": 2, "parity": False})),
    "fast_fuzz_r6": ("fuzz", (20000, 2, {"reflect": 6, "parity": False})),
    "flagship_96x54": ("flagship_scene", (96, 54, {}, 0)),
    "flagship_32x24_s2": ("flagship_scene", (32, 24, {"samples": 2}, 0)),
    "fused_96x54": ("flagship_scene", (96, 54, {"fused": True}, 0)),
    "fast_ptrace_32x18": ("ptrace_scene", (32, 18, {}, 1)),
    "fast_maze_96x54": ("maze_scene", (96, 54, {}, 0)),
    "fast_maze_96x54_portal": ("maze_scene", (96, 54, {"view": "portal"},
                                              0)),
    "fused_maze_48x27_portal": ("maze_scene", (48, 27, {"fused": True,
                                                        "view": "portal"},
                                               0)),
    "fast_chain_96x54": ("stress_scene", (96, 54, {}, 0)),
    "fast_sph64_64x36": ("spheres_scene", (64, 36, {}, 0)),
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


def load():
    """The host library (built by `build`), its entries typed."""
    lib = ctypes.CDLL(build())
    lib.pwnfps_host_trace.argtypes = [ctypes.c_char_p]
    lib.pwnfps_host_math.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                     ctypes.c_void_p, ctypes.c_int]
    return lib


@contextlib.contextmanager
def host_math(lib):
    """While the block runs, the plain tracer's fast mode
    (tracer_core.FAST_MATH) takes the host library's rsqrtf, sqrtf, sinf,
    cosf and expf, the functions the host build of the kernel body
    calls, in place of torch's."""
    def fn(k):
        def f(x):
            x = torch.as_tensor(x, dtype=torch.float32).contiguous()
            y = torch.empty_like(x)
            if lib.pwnfps_host_math(k, x.data_ptr(), y.data_ptr(),
                                    x.numel()) != 0:
                raise ValueError(f"no host function {k}")
            return y
        return f
    saved = tracer_core.FAST_MATH
    tracer_core.FAST_MATH = saved._replace(rsq=fn(0), sqrt=fn(1), sin=fn(2),
                                           cos=fn(3), exp=fn(4))
    try:
        yield
    finally:
        tracer_core.FAST_MATH = saved


def inputs(name: str):
    """(tworld, cfg, ifrom, rays, seeds, sec, page0) of a case, on the
    CPU."""
    make, arg = CASES[name]
    if make == "fuzz":
        n, seed, kw = arg
        wt, cfg, ifrom, rays, seeds = S.fuzz_rays(n, "cpu", seed, **kw)
        return wt, cfg, ifrom, rays, seeds, SEC, 0
    w, h, kw, k = arg
    if make == "spheres_scene":
        sc = S.spheres_scene(64, w, h, "cpu", **kw)
    else:
        sc = getattr(S, make)(w, h, "cpu", **kw)
    origin, rayb, rdx, rdy, sec = sc.frame_args(k)
    ifrom, rays, seeds = frame_rays(sc.cfg, origin, rayb, rdx, rdy, "cpu")
    return sc.tworld, sc.cfg, ifrom, rays, seeds, sec, sc.cfg.cam_page


def run(lib, name: str, knobs: str = "none", case=None) -> dict:
    """{"fb", "zbuf", "tstep"}: the shares of equal fb words (of equal
    colour words with knobs "unpacked"), of equal zbuf words and, where
    the knobs profile, of equal per-wave step counts (else None) between
    the host build and the plain tracer on a case (or on `case`, inputs'
    tuple), the plain tracer's fast mode on the host's math functions."""
    wt, cfg, ifrom, rays, seeds, sec, page0 = case or inputs(name)
    cfg = dataclasses.replace(cfg, **KNOBS[knobs])
    unpacked = knobs == "unpacked"
    segs = [] if cfg.profile and cfg.samples == 1 else None
    with contextlib.nullcontext() if cfg.parity else host_math(lib):
        out_p, z_p = tracer.trace_wave_plain(wt, cfg, ifrom, rays, seeds,
                                             sec, not unpacked, page0=page0,
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
    if unpacked:
        same = (col.view(torch.int32)
                == torch.stack(list(out_p)).view(torch.int32)).all(0)
    else:
        same = fb == out_p
    ts = None
    if segs is not None:
        ts = float((tstep == torch.stack([o.tstep for o in segs]))
                   .double().mean())
    return {"fb": float(same.double().mean()),
            "zbuf": float((z.view(torch.int32) == z_p.view(torch.int32))
                          .double().mean()),
            "tstep": ts}


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
    lib = load()
    ok = True
    for name in args.cases or list(CASES):
        for knobs in args.knobs:
            t0 = time.time()
            r = run(lib, name, knobs)
            ok = ok and all(v in (None, 1.0) for v in r.values())
            ts = "" if r["tstep"] is None else f", tstep equal {r['tstep']:.6f}"
            print(f"{name} ({knobs}): fb equal {r['fb']:.6f}, zbuf equal "
                  f"{r['zbuf']:.6f}{ts} ({time.time() - t0:.1f} s)",
                  flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
