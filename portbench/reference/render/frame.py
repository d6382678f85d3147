# Frozen copy of the plain frame glue of pwnfps_tpu_torch/render/frame.py
# (gen_rays, pixel_seeds) and of the plain DoF pass of
# pwnfps_tpu_torch/ops/blur.py (draw_tables, _avg_epu8 ... dof_blur_plain),
# commit fea5a14, for the benchmark's plain reference.  It imports nothing
# of pwnfps_tpu_torch, pwnfps_tpu or jax.
"""Ray generation, pixel seeds and the DoF pass in plain torch."""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..core import lcg
from ..core.ieee import to_i32
from ..ops.vec import V3


def gen_rays(rayb, rdx, rdy, width: int, height: int,
             parity: bool = False) -> V3:
    """Per-pixel ray directions as V3 of [h*w] tensors (frame.py:41-70).

    Pixel (x, y) uses (rayb + y*rdy) + (x+1)*rdx in fast mode.  Parity
    mode replays the reference's serial accumulation (screen.h:12-24):
    each 32-wide tile starts at (rayb + y*rdy) + (32t)*rdx and adds rdx
    once per pixel, 32 separate adds in order (a scan would reassociate
    them and round elsewhere)."""
    dev = rayb.device
    ys = torch.arange(height, dtype=torch.int32, device=dev).to(
        torch.float32)
    if not parity:
        xs = torch.arange(1, width + 1, dtype=torch.int32, device=dev).to(
            torch.float32)

        def comp(i):
            v = (rayb[i] + ys[:, None] * rdy[i]) + xs[None, :] * rdx[i]
            return v.reshape(-1)

        return V3(comp(0), comp(1), comp(2))
    tiles = -(-width // 32)
    tx = (torch.arange(tiles, dtype=torch.int32, device=dev) * 32).to(
        torch.float32)
    # [3, h, tiles]: the three components advance together
    b, dx, dy = (v.reshape(3, 1, 1) for v in (rayb, rdx, rdy))
    acc = (b + ys[None, :, None] * dy) + tx[None, None, :] * dx
    cols = []
    for _ in range(32):
        acc = acc + dx
        cols.append(acc)
    v = torch.stack(cols, dim=3).reshape(3, height, tiles * 32)
    v = v[:, :, :width].reshape(3, -1)
    return V3(v[0], v[1], v[2])


def pixel_seeds(width: int, height: int, device) -> torch.Tensor:
    """Per-pixel primary-ray seeds, row-major [h*w] int32 (uint32 bits)."""
    xs = torch.arange(width, dtype=torch.int64, device=device)
    ys = torch.arange(height, dtype=torch.int64, device=device)
    s = lcg.pixel_seed(xs[None, :], ys[:, None], width)
    return lcg.to_i32_bits(s.reshape(-1))


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


def _avg_epu8(a, b):
    """(a+b+1)>>1 per byte, SWAR on uint32 values held in int64."""
    return (a | b) - (((a ^ b) >> 1) & 0x7F7F7F7F)


@lru_cache(maxsize=64)
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
