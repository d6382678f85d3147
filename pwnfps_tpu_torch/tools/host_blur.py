"""Rehearse the blur kernel's body on the host CPU: blur frames and bands
through csrc/blur.cu's tile functions, one tile after another, and hold
the result bit for bit against the plain passes.

    python -m pwnfps_tpu_torch.tools.host_blur

g++ builds csrc/host/host_blur.cpp, which includes csrc/blur.cu against
csrc/host/cuda_runtime.h in place of the CUDA runtime (the _rn
arithmetic the host's IEEE operations, no fused multiply-add, the
saturating truncation of cvt.rzi, the add rounded toward zero), into
_build/.  Each tile of each shape the kernel has (TWS x THS) takes its
reach, stages its window where the kernel's instance does and blurs its
pixels through the functions the kernel calls (tile_of, window_of,
stage, taps_of, window_blur, mixed_blur), so the window's clamps, the
16-byte and 4-byte staging and the choice between the window and global
memory run here before a change goes to the card.  It proves
nothing about the card's build (nvcc, cp.async, the block's reduction):
tests/test_torch_cuda.py holds that.  Each case prints whether it equals
the plain pass and its tile and tap counts; the exit code is 1 unless
every case is equal.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import os
import subprocess
import sys

import numpy as np
import torch

from .._build import BUILD_DIR, SRC_DIR
from ..core import lcg
from ..ops import blur

THS = (16, 32)          # the kernel's tile heights (32: a tap window)
TWS = (64, 32)          # and widths
# stats: tiles that staged a window, tiles that did not, taps read from a
# window, of them on its first or last row or column, taps of staged
# tiles read from global memory
STATS = ("staged", "unstaged", "window_taps", "edge_taps", "global_taps")
_LIB = None


def build() -> str:
    """The host library's path, built unless an up-to-date one exists."""
    host = os.path.join(SRC_DIR, "host")
    srcs = [os.path.join(host, "host_blur.cpp"),
            os.path.join(host, "cuda_runtime.h"),
            os.path.join(SRC_DIR, "blur.cu")]
    h = hashlib.sha256()
    for p in srcs:
        with open(p, "rb") as f:
            h.update(f.read())
    out = os.path.join(BUILD_DIR, f"host_blur-{h.hexdigest()[:16]}.so")
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        subprocess.run(["g++", "-std=c++17", "-O2", "-ffp-contract=off",
                        "-fno-fast-math", "-frounding-math",
                        "-Wno-unknown-pragmas", "-shared",
                        "-fPIC", "-I", host, "-I", SRC_DIR, srcs[0], "-o",
                        tmp], check=True)
        os.replace(tmp, out)
    return out


def lib():
    global _LIB
    if _LIB is None:
        _LIB = ctypes.CDLL(build())
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        _LIB.pwnfps_host_blur.argtypes = ([p] * 4 + [i] * 3 + [f] * 2
                                          + [i, i, p])
        _LIB.pwnfps_host_blur_band.argtypes = ([p] * 4 + [i] * 6 + [f] * 2
                                               + [i, i, p])
    return _LIB


def _stats(buf) -> dict:
    return dict(zip(STATS, (int(v) for v in buf)))


def host_blur(fb: torch.Tensor, zbuf: torch.Tensor, frame_h: int,
              th: int, tw: int = 64) -> tuple[torch.Tensor, dict]:
    """One frame-form pass of the kernel body over [rows, w] CPU tensors
    of rows / frame_h stacked frames, in tw x th tiles: (out, stats)."""
    fb, zbuf = fb.contiguous(), zbuf.contiguous()
    rows, w = fb.shape
    tab = torch.from_numpy(blur.draw_tables(w))
    out = torch.empty_like(fb)
    st = (ctypes.c_longlong * len(STATS))()
    if lib().pwnfps_host_blur(fb.data_ptr(), zbuf.data_ptr(),
                              tab.data_ptr(), out.data_ptr(), rows, w,
                              frame_h, blur._fstr(frame_h), lcg.INV_MOD_F,
                              tw, th, st):
        raise ValueError(f"host blur refused rows={rows} w={w} "
                         f"frame_h={frame_h} tile {tw}x{th}")
    return out, _stats(st)


def host_blur_band(fb_pad: torch.Tensor, zb: torch.Tensor, y0: int,
                   fh: int, th: int, tw: int = 64) -> tuple[torch.Tensor, dict]:
    """One band-form pass (dof_blur_band_plain's arguments) of the kernel
    body in tw x th tiles: (out, stats)."""
    fb_pad, zb = fb_pad.contiguous(), zb.contiguous()
    cl, hb, w = zb.shape
    halo = (fb_pad.shape[1] - hb) // 2
    tab = torch.from_numpy(blur.draw_tables(w))
    out = torch.empty(zb.shape, dtype=torch.int32)
    st = (ctypes.c_longlong * len(STATS))()
    if lib().pwnfps_host_blur_band(fb_pad.data_ptr(), zb.data_ptr(),
                                   tab.data_ptr(), out.data_ptr(), cl, hb,
                                   halo, w, y0, fh, blur._fstr(fh),
                                   lcg.INV_MOD_F, tw, th, st):
        raise ValueError(f"host band blur refused {tuple(fb_pad.shape)}")
    return out, _stats(st)


def reach_frame(h: int, w: int, seed: int, nf: int = 1,
                tiles=((0.3, 0.5), (0.25, 0.9), (0.2, 1.2), (0.25, 0.0)),
                extremes: bool = True):
    """(fb, zbuf) of nf stacked h x w frames whose depths mix tiles the
    window covers with tiles over its cap: each 16 x 16 block of pixels
    draws its |z - 1| up to a share of the cap's depth, RCAP - 2 = 22
    pixels over fstr, from `tiles` ((probability, share) pairs); with
    `extremes`, NaN depths sprinkled over every block (a NaN tap reads
    frame row 0, column 0, and leaves the reach as it is) and one +-inf
    or +-1e30 depth in one block in 16 (its tile goes over the cap)."""
    rng = np.random.default_rng(seed)
    fstr = blur._fstr(h)
    rows = nf * h
    fb = torch.from_numpy(rng.integers(0, 2 ** 32, (rows, w), dtype=np.uint64)
                          .astype(np.uint32).view(np.int32))
    p = np.array([t[0] for t in tiles])
    share = np.array([t[1] for t in tiles])[rng.choice(
        len(tiles), ((rows + 15) // 16, (w + 15) // 16), p=p / p.sum())]
    share = np.kron(share, np.ones((16, 16)))[:rows, :w]
    z = 1.0 + share * (22.0 / fstr) * rng.uniform(-1.0, 1.0, (rows, w))
    z = z.astype(np.float32)
    if extremes:
        z[rng.random((rows, w)) < 0.005] = np.nan
        for by, bx in zip(*np.nonzero(rng.random(share[::16, ::16].shape)
                                      < 1 / 16)):
            y, x = min(16 * by + 7, rows - 1), min(16 * bx + 5, w - 1)
            z[y, x] = rng.choice([np.inf, -np.inf, 1e30, -1e30])
    return fb, torch.from_numpy(z)


def band_inputs(fb: torch.Tensor, z: torch.Tensor, hb: int, halo: int,
                nrow: int):
    """[(fb_pad, zb, y0)] of nrow bands of hb rows of the [cl, h, w]
    frames, padded as the mesh pads them (zero halo rows past the frame,
    depth 1 on pad rows)."""
    h = fb.shape[1]
    hp2 = hb * nrow
    fbp = torch.nn.functional.pad(fb, (0, 0, halo, hp2 - h + halo))
    zp = torch.nn.functional.pad(z, (0, 0, 0, hp2 - h), value=1.0)
    return [(fbp[:, y0:y0 + hb + 2 * halo].contiguous(),
             zp[:, y0:y0 + hb].contiguous(), y0)
            for y0 in range(0, hp2, hb)]


def cases():
    """(name, run) pairs: run() -> (equal, stats summed over its passes)."""
    def frame(h, w, nf, seed, ths=THS):
        def run():
            fb, z = reach_frame(h, w, seed, nf)
            want = blur.dof_blur_plain(fb, z, 1, h)
            eq, tot = True, dict.fromkeys(STATS, 0)
            for th in ths:
                for tw in TWS:
                    got, st = host_blur(fb, z, h, th, tw)
                    eq = eq and torch.equal(got, want)
                    tot = {k: tot[k] + st[k] for k in STATS}
            return eq, tot
        return run

    def band(h, w, cl, hb, halo, seed, th=32):
        def run():
            fb, z = reach_frame(h, w, seed, cl)
            fb, z = fb.view(cl, h, w), z.view(cl, h, w)
            eq, tot = True, dict.fromkeys(STATS, 0)
            for fp, zb, y0 in band_inputs(fb, z, hb, halo, -(-h // hb)):
                got, st = host_blur_band(fp, zb, y0, h, th)
                eq = eq and torch.equal(
                    got, blur.dof_blur_band_plain(fp, zb, y0, h))
                tot = {k: tot[k] + st[k] for k in STATS}
            return eq, tot
        return run

    return [("frame_150x203", frame(150, 203, 1, 1)),
            ("frames_3x40x132", frame(40, 132, 3, 2)),
            ("frame_120x160", frame(120, 160, 1, 3)),
            ("band_100x131", band(100, 131, 2, 24, 20, 4)),
            ("band_96x128", band(96, 128, 1, 40, 24, 5, th=32))]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.parse_args(argv)
    ok = True
    for name, run in cases():
        eq, st = run()
        ok = ok and eq
        print(f"{name}: {'equal' if eq else 'DIFFERENT'} {st}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
