"""Multi-bounce trace entry point (pwnfps_tpu/ops/tracer_jnp.py:
trace_wave and tracer_pallas.py:trace_wave_pallas).

`trace_wave_plain` runs the plain torch tracer (ops/tracer_core.py) on
any device.  `trace_wave` takes it for CPU tensors and launches the
CUDA kernel of csrc/tracer.cu for CUDA tensors: entry `pwnfps_trace` in
fast mode, `pwnfps_trace_parity` when `cfg.parity` is set.  The kernel
replaces the TPU kernel pwnfps_tpu/ops/tracer_pallas.py:_kernel: one
page in both modes, and paged worlds in fast mode, where every ray
starts on the scalar page `page0` (the TPU kernel's `page0_ref`,
tracer_pallas.py:648).  In either mode `cfg.samples > 1` traces the
primary wave once and `samples` bounce chains from it, and writes their
mean (tracer_core.trace_wave_env).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from ..core import lcg
from ..core.config import RenderConfig
from .tracer_core import check_config, col_ftoint, trace_wave_env
from .vec import V3
from .world import SPH_COLS, TorchWorld

# launches of each kernel variant since import (reset by callers that
# count), each launch in one counter: LAUNCHES fast mode on a one-page
# world, LAUNCHES_PAGED fast mode on a paged world (the same entry),
# LAUNCHES_SAMPLES fast mode with cfg.samples > 1 (the same entry, on
# either kind of world), LAUNCHES_PARITY parity mode with one sample,
# LAUNCHES_PARITY_SAMPLES parity mode with cfg.samples > 1 (the same entry)
LAUNCHES = 0
LAUNCHES_PAGED = 0
LAUNCHES_SAMPLES = 0
LAUNCHES_PARITY = 0
LAUNCHES_PARITY_SAMPLES = 0
# C entry points of csrc/tracer.cu
_SIGS = {"pwnfps_trace": [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9
         + [ctypes.c_float] * 4 + [ctypes.c_void_p] * 3,
         "pwnfps_trace_parity": [ctypes.c_void_p] * 13 + [ctypes.c_int] * 6
         + [ctypes.c_float] * 3 + [ctypes.c_void_p] * 3}


def trace_wave_plain(wt: TorchWorld, cfg: RenderConfig, ifrom: V3,
                     iray: V3, seed: torch.Tensor, sec, pack: bool = False,
                     counts: dict | None = None, page0: int = 0):
    """Plain torch trace.  seed: int32 [n] (uint32 bits); page0: the
    page every ray starts on.  Returns (C4, dist), or (fb int32 BGRA
    bits, dist) with pack=True.  counts: see tracer_core.run_segment."""
    page = torch.full_like(seed, page0)
    col, dist = trace_wave_env(wt, cfg, ifrom, iray, lcg.u32(seed), sec,
                               page, counts)
    return (col_ftoint(col), dist) if pack else (col, dist)


def _check_inputs(wt: TorchWorld, ifrom: V3, iray: V3, seed, page0: int):
    if not 0 <= page0 < wt.n_pages:
        raise ValueError(f"start page {page0} is not a page of a "
                         f"{wt.n_pages}-page world")
    n = ifrom.x.shape[0]
    for t in (*ifrom, *iray):
        if t.shape != (n,) or t.dtype != torch.float32:
            raise ValueError("ifrom/iray components must be float32 [n]")
    if seed.shape != (n,) or seed.dtype != torch.int32:
        raise ValueError("seed must be int32 [n] (uint32 bits)")
    tables = (wt.ent, wt.word, wt.sph, wt.bound, wt.buckets, wt.rsqrt_tab,
              wt.rcp_tab)
    devs = {t.device for t in (*ifrom, *iray, seed, *tables)}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")
    cells = wt.n_pages * 4096
    if (wt.ent.shape != (cells,) or wt.word.shape != (cells,)
            or not 0 <= wt.sphere_page < wt.n_pages
            or wt.sph.shape != (wt.n_spheres, SPH_COLS)
            or wt.bound.shape != (4,)
            or wt.buckets.shape != (cells * wt.k_bucket,)
            or wt.rsqrt_tab.shape != (8192,) or wt.rcp_tab.shape != (4096,)
            or any(t.dtype != torch.int32
                   for t in (wt.ent, wt.word, wt.buckets, wt.rsqrt_tab,
                             wt.rcp_tab))
            or not all(t.is_contiguous() for t in tables)):
        raise ValueError("world tables do not have world_to_torch's "
                         "shapes and layout")


def _launch(wt: TorchWorld, cfg: RenderConfig, ifrom: V3, iray: V3,
            seed: torch.Tensor, sec, page0: int):
    global LAUNCHES, LAUNCHES_PAGED, LAUNCHES_SAMPLES, LAUNCHES_PARITY, \
        LAUNCHES_PARITY_SAMPLES
    n = ifrom.x.shape[0]
    dev = ifrom.x.device
    # the contiguous copies must outlive the launch: keep them here
    keep = [t.contiguous() for t in (*ifrom, *iray, seed)]
    ins = [t.data_ptr() for t in keep]
    fb = torch.empty(n, dtype=torch.int32, device=dev)
    dist = torch.empty(n, dtype=torch.float32, device=dev)
    lib = _build.load("tracer", _SIGS)
    stream = torch.cuda.current_stream(dev).cuda_stream
    inv = float(np.float32(1.0 / cfg.samples))
    with torch.cuda.device(dev):
        if cfg.parity:
            err = lib.pwnfps_trace_parity(
                *ins, wt.ent.data_ptr(), wt.word.data_ptr(),
                wt.sph.data_ptr(), wt.buckets.data_ptr(),
                wt.rsqrt_tab.data_ptr(), wt.rcp_tab.data_ptr(),
                n, wt.n_spheres, wt.k_bucket, cfg.maxsteps, cfg.reflect,
                cfg.samples, float(np.float32(sec)), lcg.INV_MOD_F, inv,
                fb.data_ptr(), dist.data_ptr(), stream)
        else:
            err = lib.pwnfps_trace(
                *ins, wt.ent.data_ptr(), wt.word.data_ptr(),
                wt.sph.data_ptr(), wt.bound.data_ptr(),
                n, wt.n_spheres, cfg.maxsteps, cfg.reflect,
                int(cfg.space_skip and wt.skip_ok), wt.n_pages,
                wt.sphere_page, page0, cfg.samples, float(np.float32(sec)),
                float(np.float32(wt.slack)), lcg.INV_MOD_F, inv,
                fb.data_ptr(), dist.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"trace kernel launch failed: CUDA error {err}")
    if cfg.parity and cfg.samples > 1:
        LAUNCHES_PARITY_SAMPLES += 1
    elif cfg.parity:
        LAUNCHES_PARITY += 1
    elif cfg.samples > 1:
        LAUNCHES_SAMPLES += 1
    elif wt.n_pages > 1:
        LAUNCHES_PAGED += 1
    else:
        LAUNCHES += 1
    return fb, dist


def trace_wave(wt: TorchWorld, cfg: RenderConfig, ifrom: V3, iray: V3,
               seed: torch.Tensor, sec, pack: bool = False, page0: int = 0):
    """Full multi-bounce trace of n rays, each starting on page `page0`,
    averaged over cfg.samples bounce chains.  Returns (C4 of [n], dist
    [n]), or (fb int32 [n] BGRA bits, dist [n]) with pack=True.  The
    kernel writes packed BGRA only, so CUDA tensors need pack=True."""
    check_config(cfg, wt.n_pages)
    if cfg.samples < 1:
        raise ValueError(f"samples={cfg.samples}: need at least one")
    _check_inputs(wt, ifrom, iray, seed, page0)
    dev = ifrom.x.device
    if dev.type == "cpu":
        return trace_wave_plain(wt, cfg, ifrom, iray, seed, sec, pack,
                                page0=page0)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not pack:
        raise NotImplementedError("the trace kernel writes packed BGRA "
                                  "only: pass pack=True")
    return _launch(wt, cfg, ifrom, iray, seed, sec, page0)
