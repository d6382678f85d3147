"""Batched multi-camera render (pwnfps_tpu/parallel/sharding.py), on one
device.

`render_cameras` renders C viewpoints of one world a step, as RL-style
rollouts do (BASELINE config #4): ray generation for every camera on
the device, one trace over all C x h x w rays and, with
`cfg.postproc_blur`, one blur launch a pass over the C stacked frames,
each blurred within its own rows.  On CUDA tensors the trace and the
blur are the kernels of ops/tracer.py and ops/blur.py; on CPU tensors
their plain versions.  The JAX package shards the same batch over a
(cam, px) device mesh; the port's multi-GPU mesh is later work, so
there is no `mesh` argument yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.config import RenderConfig
from ..ops.blur import dof_blur
from ..ops.tracer import trace_wave
from ..ops.vec import V3
from ..ops.world import TorchWorld
from ..ops.worlddev import WorldMeta
from ..render.frame import pixel_seeds

F32 = np.float32


def camera_rays(cfg: RenderConfig, cams: torch.Tensor, seeds: torch.Tensor):
    """(origins, rays, seeds) of every pixel of C cameras, flat [C*h*w]
    camera-major and row-major within a camera (sharding.py:114-132,
    171-176).  cams: [C, 4, 4] f32 tensor (rows: basis x, y, z, then the
    position); seeds: the [h*w] int32 seed image every camera shares."""
    h, w = cfg.height, cfg.width
    c = cams.shape[0]
    dev = cams.device
    # camera_vectors, over the batch, in sharding.py:117-125's association
    xrat = F32(-1.0)
    yrat = -(F32(h) / F32(w))
    xsrat = float(F32(2.0) * xrat / F32(w))
    ysrat = float(F32(2.0) * yrat / F32(h))
    rayb = cams[:, 2, :3] + (float(-xrat) * cams[:, 0, :3]
                             + float(-yrat) * cams[:, 1, :3])   # [C, 3]
    rdx = xsrat * cams[:, 0, :3]
    rdy = ysrat * cams[:, 1, :3]
    ys = torch.arange(h, dtype=torch.int32, device=dev).to(torch.float32)
    xs = torch.arange(1, w + 1, dtype=torch.int32, device=dev).to(
        torch.float32)

    def comp(i):
        v = ((rayb[:, i, None, None] + ys[None, :, None]
              * rdy[:, i, None, None])
             + xs[None, None, :] * rdx[:, i, None, None])          # [C,h,w]
        return v.reshape(-1)

    n = h * w
    origins = V3(*(cams[:, 3, i].repeat_interleave(n) for i in range(3)))
    return origins, V3(comp(0), comp(1), comp(2)), seeds.repeat(c)


def _render_cams(tworld: TorchWorld, cfg: RenderConfig, cams: torch.Tensor,
                 seeds: torch.Tensor, sec):
    """The single-device camera batch (sharding.py:_render_cams_jit,
    110-196): ray generation, one trace of every camera's rays with the
    BGRA pack, then cfg.postproc_blur passes of the per-camera blur.
    Returns (fb [C, h, w] int32 BGRA bits, zbuf [C, h, w] f32)."""
    h, w = cfg.height, cfg.width
    c = cams.shape[0]
    origins, rays, seeds_flat = camera_rays(cfg, cams, seeds)
    fb, zbuf = trace_wave(tworld, cfg, origins, rays, seeds_flat, sec,
                          pack=True, page0=cfg.cam_page)
    fb, zbuf = fb.reshape(c, h, w), zbuf.reshape(c, h, w)
    if cfg.postproc_blur:
        fb = dof_blur(fb, zbuf, cfg.postproc_blur)
    return fb, zbuf


def render_cameras(tworld: TorchWorld, meta: WorldMeta, cfg: RenderConfig,
                   cams: np.ndarray, sec) -> torch.Tensor:
    """Batched multi-camera render on the world's device
    (sharding.py:674-708 on one device).  cams: [C, 4, 4] float32 camera
    matrices, as the JAX package takes them.  Returns the [C, h, w] int32
    framebuffer (uint32 BGRA bits) on the world's device.  Honours
    cfg.postproc_blur (per-camera DoF).  Parity mode is rejected, as in
    the JAX package: its serial ray-offset accumulation exists only on
    the single-camera path (render.frame.gen_rays)."""
    if cfg.parity:
        raise ValueError(
            "render_cameras is fast-mode only; parity-exact frames go "
            "through render.frame.render_frame per camera")
    if not 0 <= cfg.cam_page < meta.n_pages:
        raise ValueError(f"cam_page {cfg.cam_page} is not a page of a "
                         f"{meta.n_pages}-page world")
    cams = np.asarray(cams, np.float32)
    if cams.ndim != 3 or cams.shape[1:] != (4, 4):
        raise ValueError(f"cams {cams.shape}: need [C, 4, 4]")
    dev = tworld.device
    seeds = pixel_seeds(cfg.width, cfg.height, dev)
    fb, _ = _render_cams(tworld, cfg, torch.from_numpy(cams).to(dev), seeds,
                         F32(sec))
    return fb
