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

`dof_blur_band_plain` and `dof_blur_band` are the same pass on row
bands (pwnfps_tpu/ops/blur.py:dof_blur_band), the form the multi-device
path blurs in (parallel/sharding._dof_blur_mesh): each band carries H
halo rows above and below and comes out bit-identical to its rows of the
full-frame blur.  The CUDA entry is the second kernel of csrc/blur.cu,
which replaces the band mode of the same TPU kernel
(blur_pallas.py:_dof_blur_band).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from .. import _build
from ..core import lcg
from ..core.ieee import to_i32

# launches of the CUDA kernels since import (reset by callers that
# count): LAUNCHES every launch of the frame kernel (one a pass),
# LAUNCHES_FRAMES those of them over several stacked frames (the
# per-camera variant), LAUNCHES_BAND every launch of the band kernel
LAUNCHES = 0
LAUNCHES_FRAMES = 0
LAUNCHES_BAND = 0
# C entry points of csrc/blur.cu
_SIGS = {"pwnfps_dof_blur": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
         + [ctypes.c_float] * 2 + [ctypes.c_void_p],
         "pwnfps_dof_blur_band": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
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


def _randfs_from_state(v):
    f = (v % lcg.MOD).to(torch.float32) * lcg.INV_MOD_F
    return f * 2.0 - 1.0


def _tap_coords(tab, ys, z, fstr: float, fh: int):
    """(column, row) of each of the 4 taps of every pixel, int64
    (screen.h:92-117): tab [4, 4, w] int64 jump coefficients, ys [rows]
    int64 frame rows (row seeds and the rows' y), z = zbuf - 1 of shape
    [..., rows, w].  Columns clamp to [0, w-1], rows to [0, fh-1]."""
    w = tab.shape[-1]
    s1, _ = lcg.randi(lcg.blur_row_seed(ys))
    xf = torch.arange(w, dtype=torch.int64, device=z.device).to(
        torch.float32)
    yf = ys.to(torch.float32)
    out = []
    for i in range(4):
        stx = lcg.jump(s1[:, None], tab[0, i][None, :], tab[1, i][None, :])
        sty = lcg.jump(s1[:, None], tab[2, i][None, :], tab[3, i][None, :])
        rx = _randfs_from_state(stx)
        ry = _randfs_from_state(sty)
        tx = xf[None, :] + (rx * fstr) * z
        ty = yf[:, None] + (ry * fstr) * z
        txi = torch.clamp(to_i32(tx), 0, w - 1).to(torch.int64)
        tyi = torch.clamp(to_i32(ty), 0, fh - 1).to(torch.int64)
        out.append((txi, tyi))
    return out


def _avg_taps(taps):
    """The four taps' SWAR average, as int32 BGRA bits."""
    return lcg.to_i32_bits(_avg_epu8(_avg_epu8(taps[0], taps[1]),
                                     _avg_epu8(taps[2], taps[3])))


def _tab64(w: int, dev) -> torch.Tensor:
    """draw_tables(w) as int64 [4, 4, w]: akx, ckx, aky, cky x tap."""
    return torch.from_numpy(draw_tables(w).astype(np.int64)).to(
        dev).view(4, 4, w)


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
    tab = _tab64(w, dev)
    fstr = _fstr(fh)
    ys = torch.arange(fh, dtype=torch.int64, device=dev)
    # first flat index of each frame
    base = (torch.arange(nf, dtype=torch.int64, device=dev)
            * (fh * w))[:, None, None]
    keep = (torch.arange(w, device=dev) < 4 * (w // 4))[None, :]
    for _ in range(passes):
        flat = lcg.u32(fb).reshape(-1)
        z = (zbuf - 1.0).reshape(nf, fh, w)
        taps = [flat[base + tyi * w + txi]
                for txi, tyi in _tap_coords(tab, ys, z, fstr, fh)]
        fb = torch.where(keep, _avg_taps(taps).reshape(rows, w), fb)
    return fb


def dof_blur_band_plain(fb_pad: torch.Tensor, zb: torch.Tensor, y0: int,
                        fh: int) -> torch.Tensor:
    """One pass on row bands (pwnfps_tpu/ops/blur.py:45-106).  fb_pad:
    [cl, hb+2H, w] int32, each camera's band rows [y0, y0+hb) with H
    halo rows above and below; zb: [cl, hb, w] f32, the band's own
    rows; y0: the band's first (camera-local) row; fh: the true frame
    height (fstr and the tap-row clamp).  Returns [cl, hb, w],
    bit-identical to rows [y0, y0+hb) of dof_blur_plain on each full
    frame, provided the taps of those rows lie inside the halo.  Tap
    rows move to band-local r = row - y0 + H and the flat index is
    clipped to the band buffer, as jnp.take(mode="clip") clips it: pad
    rows past the frame (y0 + ly >= fh) tap garbage there, never past
    the buffer."""
    cl, hb, w = zb.shape
    hp = fb_pad.shape[1]
    halo = (hp - hb) // 2
    dev = fb_pad.device
    tab = _tab64(w, dev)
    ys = y0 + torch.arange(hb, dtype=torch.int64, device=dev)
    flat = lcg.u32(fb_pad).reshape(-1)
    base = (torch.arange(cl, dtype=torch.int64, device=dev)
            * (hp * w))[:, None, None]
    taps = [flat[base + torch.clamp((tyi - y0 + halo) * w + txi, 0,
                                    hp * w - 1)]
            for txi, tyi in _tap_coords(tab, ys, zb - 1.0, _fstr(fh), fh)]
    keep = (torch.arange(w, device=dev) < 4 * (w // 4))[None, :]
    return torch.where(keep, _avg_taps(taps), fb_pad[:, halo:halo + hb])


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


def _launch_band(fb_pad: torch.Tensor, zb: torch.Tensor, y0: int,
                 fh: int) -> torch.Tensor:
    global LAUNCHES_BAND
    cl, hb, w = zb.shape
    halo = (fb_pad.shape[1] - hb) // 2
    out = torch.empty(zb.shape, dtype=torch.int32, device=zb.device)
    tab = _device_tables(w, zb.device)
    lib = _build.load("blur", _SIGS)
    with torch.cuda.device(zb.device):
        err = lib.pwnfps_dof_blur_band(
            fb_pad.data_ptr(), zb.data_ptr(), tab.data_ptr(),
            out.data_ptr(), cl, hb, halo, w, y0, fh, _fstr(fh),
            lcg.INV_MOD_F, torch.cuda.current_stream(zb.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dof_blur_band kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES_BAND += 1
    return out


def dof_blur_band(fb_pad: torch.Tensor, zb: torch.Tensor, y0: int,
                  fh: int) -> torch.Tensor:
    """One DoF pass on the row bands of cl stacked cameras (see
    dof_blur_band_plain for the arguments): the band kernel of
    csrc/blur.cu for CUDA tensors, one launch covering every camera, the
    plain pass for CPU tensors.  The caller decides that the taps reach
    no further than the halo; the pass does not check."""
    if fb_pad.dim() != 3 or zb.dim() != 3 or fb_pad.shape[0] != zb.shape[0] \
            or fb_pad.shape[2] != zb.shape[2] \
            or fb_pad.shape[1] < zb.shape[1] \
            or (fb_pad.shape[1] - zb.shape[1]) % 2:
        raise ValueError(f"fb_pad {tuple(fb_pad.shape)} / zb "
                         f"{tuple(zb.shape)}: need [cl, hb+2H, w] and "
                         "[cl, hb, w]")
    if fb_pad.dtype != torch.int32 or zb.dtype != torch.float32:
        raise TypeError(f"need int32 fb_pad and float32 zb, got "
                        f"{fb_pad.dtype} and {zb.dtype}")
    if fb_pad.device != zb.device:
        raise ValueError("fb_pad and zb on different devices")
    y0, fh = int(y0), int(fh)
    if fh < 1 or y0 < 0:
        raise ValueError(f"y0={y0}, fh={fh}: need y0 >= 0 and fh >= 1")
    if zb.device.type == "cpu":
        return dof_blur_band_plain(fb_pad, zb, y0, fh)
    if zb.device.type != "cuda":
        raise ValueError(f"unsupported device {zb.device}")
    if not (fb_pad.is_contiguous() and zb.is_contiguous()):
        raise ValueError("dof_blur_band kernel needs contiguous fb_pad "
                         "and zb")
    return _launch_band(fb_pad, zb, y0, fh)
