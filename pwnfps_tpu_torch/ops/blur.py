"""Depth-of-field post-process (reference screen.h:69-123).

`dof_blur_plain` is the plain torch pass, a port of
pwnfps_tpu/ops/blur.py:dof_blur: per pixel, 4 jittered taps at offsets
proportional to (z - 1), from per-row LCG streams jumped analytically
per (pixel, tap), averaged with `_mm_avg_epu8` semantics.  The last
`w % 4` pixels pass through; tap coordinates truncate (saturating) and
clamp to the frame.

`dof_blur` is the entry point: CPU tensors take the plain pass, CUDA
tensors the kernel of csrc/blur.cu (which replaces the TPU kernel
pwnfps_tpu/ops/blur_pallas.py:_blur_kernel), one launch per pass.  Both
take a stack of camera frames (`frame_h`, blur_pallas.py:510-520) and
blur each within its own rows: row seeds from the frame-local row, taps
clamped to the frame, `fstr` from the frame's height.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from .. import _build
from ..core import lcg
from ..core.ieee import to_i32

# launches of the CUDA kernel since import (reset by callers that
# count): LAUNCHES every launch (one a pass), LAUNCHES_FRAMES those of
# them over several stacked frames (the per-camera variant)
LAUNCHES = 0
LAUNCHES_FRAMES = 0
# C entry points of csrc/blur.cu
_SIGS = {"pwnfps_dof_blur": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
         + [ctypes.c_float] * 2 + [ctypes.c_void_p]}


@lru_cache(maxsize=8)
def draw_tables(width: int) -> np.ndarray:
    """[16, w] int32 jump coefficients (blur._draw_tables): rows 0-3
    A^d of tap i's x draw, 4-7 its C_d, 8-11 / 12-15 the same for the y
    draw.  Pixel x (group g = x//4, lane j = x%4), tap i consumes draws
    d = 32g + (4i + j)*2 (x offset) and d+1 (y offset)."""
    x = np.arange(width)
    g, j = x // 4, x % 4
    i = np.arange(4)
    d = 32 * g[:, None] + (4 * i[None, :] + j[:, None]) * 2      # [w, 4]
    ak, ck = lcg.jump_coeffs(int(d.max()) + 2)
    tab = np.concatenate([ak[d].T, ck[d].T, ak[d + 1].T, ck[d + 1].T])
    return np.ascontiguousarray(tab.astype(np.int32))


@lru_cache(maxsize=8)
def _device_tables(width: int, device: torch.device) -> torch.Tensor:
    """draw_tables(width) on `device`, uploaded once per width and
    device instead of on every call."""
    return torch.from_numpy(draw_tables(width)).to(device)


def _avg_epu8(a, b):
    """(a+b+1)>>1 per byte, SWAR on uint32 values held in int64."""
    return (a | b) - (((a ^ b) >> 1) & 0x7F7F7F7F)


def _fstr(h: int) -> float:
    return float(np.float32(0.002) * np.float32(h))    # screen.h:86


def _frames(rows: int, frame_h: int | None) -> int:
    """Frame height of a stack of `rows` rows: frame_h, which must
    divide rows, or rows (one frame)."""
    fh = rows if frame_h is None else int(frame_h)
    if fh < 1 or rows % fh:
        raise ValueError(f"frame_h={frame_h} must divide the {rows} rows")
    return fh


def dof_blur_plain(fb: torch.Tensor, zbuf: torch.Tensor, passes: int = 1,
                   frame_h: int | None = None) -> torch.Tensor:
    """fb: [rows, w] int32 (uint32 BGRA bits), zbuf: [rows, w] f32.
    rows = C * frame_h: C frames stacked vertically, each blurred within
    its own rows (blur_pallas.py:510-520), bit-identical to blurring each
    alone; frame_h None is one frame."""
    rows, w = fb.shape
    fh = _frames(rows, frame_h)
    nf = rows // fh
    dev = fb.device
    tab = torch.from_numpy(draw_tables(w).astype(np.int64)).to(dev)
    tab = tab.view(4, 4, w)                 # akx, ckx, aky, cky x tap
    fstr = _fstr(fh)
    ys = torch.arange(fh, dtype=torch.int64, device=dev)
    s1, _ = lcg.randi(lcg.blur_row_seed(ys))
    xs = torch.arange(w, dtype=torch.int64, device=dev)
    xf = xs.to(torch.float32)
    yf = ys.to(torch.float32)
    # first flat index of each frame
    base = (torch.arange(nf, dtype=torch.int64, device=dev)
            * (fh * w))[:, None, None]

    def randfs_from_state(v):
        f = (v % lcg.MOD).to(torch.float32) * lcg.INV_MOD_F
        return f * 2.0 - 1.0

    keep = (xs < 4 * (w // 4))[None, :]
    for _ in range(passes):
        flat = lcg.u32(fb).reshape(-1)
        z = (zbuf - 1.0).reshape(nf, fh, w)
        taps = []
        for i in range(4):
            stx = lcg.jump(s1[:, None], tab[0, i][None, :], tab[1, i][None, :])
            sty = lcg.jump(s1[:, None], tab[2, i][None, :], tab[3, i][None, :])
            rx = randfs_from_state(stx)
            ry = randfs_from_state(sty)
            tx = xf[None, :] + (rx * fstr) * z
            ty = yf[:, None] + (ry * fstr) * z
            txi = torch.clamp(to_i32(tx), 0, w - 1).to(torch.int64)
            tyi = torch.clamp(to_i32(ty), 0, fh - 1).to(torch.int64)
            taps.append(flat[base + tyi * w + txi])
        acc = _avg_epu8(_avg_epu8(taps[0], taps[1]),
                        _avg_epu8(taps[2], taps[3]))
        fb = torch.where(keep, lcg.to_i32_bits(acc).reshape(rows, w), fb)
    return fb


def _launch(fb: torch.Tensor, zbuf: torch.Tensor, tab: torch.Tensor,
            fh: int) -> torch.Tensor:
    global LAUNCHES, LAUNCHES_FRAMES
    rows, w = fb.shape
    out = torch.empty_like(fb)
    lib = _build.load("blur", _SIGS)
    with torch.cuda.device(fb.device):
        err = lib.pwnfps_dof_blur(
            fb.data_ptr(), zbuf.data_ptr(), tab.data_ptr(), out.data_ptr(),
            rows, w, fh, _fstr(fh), lcg.INV_MOD_F,
            torch.cuda.current_stream(fb.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dof_blur kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    if fh < rows:
        LAUNCHES_FRAMES += 1
    return out


def dof_blur(fb: torch.Tensor, zbuf: torch.Tensor, passes: int = 1,
             frame_h: int | None = None) -> torch.Tensor:
    """One or more DoF passes; the CUDA kernel for CUDA tensors (one
    launch a pass, whatever the number of frames), the plain pass for
    CPU tensors.  fb/zbuf: [rows, w] with rows = C * frame_h stacked
    frames (frame_h None: one frame), or [C, h, w] (frame_h = h).  Each
    frame is blurred within its own rows.  Output is a new tensor of
    fb's shape."""
    if fb.dim() not in (2, 3) or zbuf.shape != fb.shape:
        raise ValueError(f"fb {tuple(fb.shape)} / zbuf "
                         f"{tuple(zbuf.shape)}: need equal [h, w] or "
                         "[C, h, w]")
    if fb.dtype != torch.int32 or zbuf.dtype != torch.float32:
        raise TypeError(f"need int32 fb and float32 zbuf, got {fb.dtype} "
                        f"and {zbuf.dtype}")
    if fb.device != zbuf.device:
        raise ValueError("fb and zbuf on different devices")
    shape = fb.shape
    if fb.dim() == 3:
        if frame_h not in (None, shape[1]):
            raise ValueError(f"frame_h={frame_h} for [C, h, w] frames of "
                             f"height {shape[1]}")
        frame_h = shape[1]
        fb = fb.reshape(-1, shape[2])
        zbuf = zbuf.reshape(-1, shape[2])
    fh = _frames(fb.shape[0], frame_h)
    if fb.device.type == "cpu":
        return dof_blur_plain(fb, zbuf, passes, fh).view(shape)
    if fb.device.type != "cuda":
        raise ValueError(f"unsupported device {fb.device}")
    if not (fb.is_contiguous() and zbuf.is_contiguous()):
        raise ValueError("dof_blur kernel needs contiguous fb and zbuf")
    tab = _device_tables(fb.shape[1], fb.device)
    for _ in range(passes):
        fb = _launch(fb, zbuf, tab, fh)
    return fb.view(shape)
