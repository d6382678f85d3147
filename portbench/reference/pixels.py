"""Any pixels of some frames, and their work, in plain torch.

Every ray of a frame is traced independently of the others (the plain
tracer's loops mask or compact the lanes they are done with), so chosen
pixels can be traced alone, and the rays of several frames, each with
its own origin and clock, in one call.  The plain tracer's time follows
its longest ray's steps more than its number of rays, so one call for
all frames costs about what one frame does.

The DoF pass reads, for each pixel, four taps whose places follow from
the pixel's own depth, so a pixel after P passes needs the depth of
itself and the colour of its taps after P - 1 passes: `render_pixels`
traces exactly that set, P times widened, into full-frame buffers, and
runs the full-frame plain pass over them, which is right wherever the
set was traced.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from .core import lcg
from .core.config import RenderConfig
from .ops.tracer_core import col_ftoint, trace_wave_env
from .ops.vec import V3
from .ops.world import TorchWorld
from .render.frame import _fstr, _tab64, _tap_coords, dof_blur_plain, \
    gen_rays, pixel_seeds


class Frame:
    """A frame's origin, rays, seeds and clock on `device`, and the
    buffers of its traced pixels.  args = (origin, rayb, rdx, rdy, sec);
    ray_dtype: a lower float type the ray directions are rounded through
    (the control's precision), or None."""

    def __init__(self, cfg: RenderConfig, args, device, ray_dtype=None):
        origin, rayb, rdx, rdy, sec = args

        def vec(v):
            return torch.as_tensor(np.asarray(v, np.float32), device=device)
        rays = gen_rays(vec(rayb), vec(rdx), vec(rdy), cfg.width,
                        cfg.height, cfg.parity)
        if ray_dtype is not None:
            rays = V3(*(c.to(ray_dtype).to(torch.float32) for c in rays))
        self.origin, self.rays = vec(origin), rays
        self.seeds = pixel_seeds(cfg.width, cfg.height, device)
        self.sec = np.float32(sec)
        n = cfg.width * cfg.height
        self.fb = torch.zeros(n, dtype=torch.int32, device=device)
        self.z = torch.ones(n, dtype=torch.float32, device=device)
        self.done = torch.zeros(n, dtype=torch.bool, device=device)


def trace(wt: TorchWorld, cfg: RenderConfig, parts, counts=None):
    """Trace the pixels idx of each (Frame, idx) of parts in one call,
    each ray from its frame's origin at its frame's clock, starting on
    page cfg.cam_page; fills the frames' fb, z and done there."""
    parts = [(f, idx) for f, idx in parts if idx.numel()]
    if not parts:
        return
    dev = wt.ent.device
    rays = V3(*(torch.cat([getattr(f.rays, c)[idx] for f, idx in parts])
                for c in "xyz"))
    ifrom = V3(*(torch.cat([f.origin[i].expand(idx.numel())
                            for f, idx in parts]).contiguous()
                 for i in range(3)))
    seeds = torch.cat([f.seeds[idx] for f, idx in parts])
    sec = torch.cat([torch.full((idx.numel(),), float(f.sec),
                                dtype=torch.float32, device=dev)
                     for f, idx in parts])
    page = torch.full_like(seeds, cfg.cam_page)
    col, dist = trace_wave_env(wt, cfg, ifrom, rays, lcg.u32(seeds), sec,
                               page, counts)
    fb = col_ftoint(col)
    at = 0
    for f, idx in parts:
        k = idx.numel()
        f.fb[idx], f.z[idx] = fb[at:at + k], dist[at:at + k]
        f.done[idx] = True
        at += k


def _taps(zbuf: torch.Tensor, idx: torch.Tensor, w: int, h: int):
    """Flat indices of the 4 DoF taps of each pixel idx, from the depth
    of those pixels in zbuf [h*w] (the others' depth is not read)."""
    dev = zbuf.device
    ys = torch.arange(h, dtype=torch.int64, device=dev)
    coords = _tap_coords(_tab64(w, dev), ys, (zbuf - 1.0).view(1, h, w),
                         _fstr(h), h)
    return torch.cat([(tyi * w + txi).reshape(-1)[idx]
                      for txi, tyi in coords])


def render_pixels(wt: TorchWorld, cfg: RenderConfig, frames,
                  ray_dtype=None):
    """[(fb int32 [k], zbuf f32 [k])] of the pixels idx (int64 flat
    indices, row-major) of each frame of frames = [(args, idx)], args =
    (origin, rayb, rdx, rdy, sec), after cfg.postproc_blur DoF passes."""
    w, h = cfg.width, cfg.height
    dev = wt.ent.device
    fs = [Frame(cfg, args, dev, ray_dtype) for args, _ in frames]
    need = [torch.unique(idx.to(dev)) for _, idx in frames]

    def fill():
        trace(wt, cfg, [(f, p[~f.done[p]]) for f, p in zip(fs, need)])

    fill()
    for _ in range(cfg.postproc_blur):
        need = [torch.unique(torch.cat([p, _taps(f.z, p, w, h)]))
                for f, p in zip(fs, need)]
        fill()
    out = []
    for f, (_, idx) in zip(fs, frames):
        fb = f.fb.view(h, w)
        if cfg.postproc_blur:
            fb = dof_blur_plain(fb, f.z.view(h, w), cfg.postproc_blur)
        idx = idx.to(dev)
        out.append((fb.reshape(-1)[idx], f.z[idx]))
    return out


def count_work(wt: TorchWorld, cfg: RenderConfig, frames) -> dict:
    """The plain tracer's work counts (steps, segments, sphere or slot
    tests) of the whole frames of `frames` (args each), summed."""
    dev = wt.ent.device
    n = cfg.width * cfg.height
    fs = [Frame(cfg, args, dev) for args in frames]
    counts = collections.Counter()
    trace(wt, cfg, [(f, torch.arange(n, device=dev)) for f in fs], counts)
    return dict(counts)
