"""Frame renderer (pwnfps_tpu/render/frame.py).

ray gen -> multi-bounce trace with in-kernel BGRA8 pack -> DoF blur.
On CUDA tensors the trace and the blur are one kernel launch each
(ops/tracer.py, ops/blur.py); on CPU tensors both take their plain
torch versions.  Fast mode and parity mode (`cfg.parity`) on one page;
fast mode on a paged world, every primary ray starting on
`cfg.cam_page`.  `render_accumulated` is the multi-sample frame
(BASELINE config #5), in either mode: the trace averages `samples`
bounce chains a pixel in the same one launch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import lcg
from ..core.config import RenderConfig
from ..ops.blur import dof_blur
from ..ops.tracer import trace_wave
from ..ops.vec import V3
from ..ops.world import TorchWorld
from ..ops.worlddev import WorldMeta


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


def _vec3(v, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v, np.float32), device=device)


def render_frame(world: TorchWorld, meta: WorldMeta, cfg: RenderConfig,
                 origin, rayb, rdx, rdy, sec):
    """-> (framebuffer [h, w] int32 holding uint32 BGRA, zbuf [h, w] f32),
    on the world's device.  origin/rayb/rdx/rdy: float32 [3] (numpy or
    tensors, as render/camera.camera_vectors gives them); sec: the clock.
    """
    if not 0 <= cfg.cam_page < meta.n_pages:
        raise ValueError(f"cam_page {cfg.cam_page} is not a page of a "
                         f"{meta.n_pages}-page world")
    dev = world.device
    h, w = cfg.height, cfg.width
    rays = gen_rays(_vec3(rayb, dev), _vec3(rdx, dev), _vec3(rdy, dev),
                    w, h, cfg.parity)
    n = h * w
    o = _vec3(origin, dev)
    ifrom = V3(*(o[i].expand(n) for i in range(3)))
    seeds = pixel_seeds(w, h, dev)
    fb, zbuf = trace_wave(world, cfg, ifrom, rays, seeds, sec, pack=True,
                          page0=cfg.cam_page)
    fb, zbuf = fb.reshape(h, w), zbuf.reshape(h, w)
    if cfg.postproc_blur:
        fb = dof_blur(fb, zbuf, cfg.postproc_blur)
    return fb, zbuf


def render_accumulated(world: TorchWorld, meta: WorldMeta,
                       cfg: RenderConfig, origin, rayb, rdx, rdy, sec,
                       samples: int = 4):
    """Distribution path tracing (pwnfps_tpu/render/frame.py:186-218):
    the mean of `samples` chains a pixel, whose reflect jitter draws from
    the seed streams pixel_seed + k*0x9E3779B9, sharing the primary wave.
    Fast mode, or parity mode (cfg.parity) on a one-page world, where
    each chain is the pixel-exact parity chain.  Returns (fb [h, w] int32 BGRA of the mean, zbuf
    [h, w] of the primary wave), with cfg.postproc_blur DoF passes on
    that zbuf."""
    return render_frame(world, meta, dataclasses.replace(cfg,
                                                         samples=samples),
                        origin, rayb, rdx, rdy, sec)


def upscale(fb: np.ndarray, scale: int) -> np.ndarray:
    """Nearest-neighbour integer upscale (screen.h:126-149), host-side."""
    return np.repeat(np.repeat(fb, scale, axis=0), scale, axis=1)


def fb_to_rgb(fb: np.ndarray) -> np.ndarray:
    """uint32 BGRA framebuffer -> [h,w,3] uint8 RGB for export."""
    px = np.ascontiguousarray(fb).view(np.uint8).reshape(*fb.shape, 4)
    return px[..., [2, 1, 0]]
