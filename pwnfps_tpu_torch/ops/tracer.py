"""Multi-bounce trace entry point (pwnfps_tpu/ops/tracer_jnp.py:
trace_wave and tracer_pallas.py:trace_wave_pallas).

`trace_wave_plain` runs the plain torch tracer (ops/tracer_core.py) on
any device.  `trace_wave` takes it for CPU tensors and launches the
CUDA kernel of csrc/tracer.cu for CUDA tensors; that kernel replaces
the TPU kernel pwnfps_tpu/ops/tracer_pallas.py:_kernel (fast mode, one
page).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from pwnfps_tpu.core.config import RenderConfig

from .. import _build
from ..core import lcg
from .tracer_core import check_config, col_ftoint, trace_wave_env
from .vec import V3
from .world import SPH_COLS, TorchWorld

# launches of the CUDA kernel since import (reset by callers that count)
LAUNCHES = 0
# C entry points of csrc/tracer.cu
_SIGS = {"pwnfps_trace": [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
         + [ctypes.c_float] * 3 + [ctypes.c_void_p] * 3}


def trace_wave_plain(wt: TorchWorld, cfg: RenderConfig, ifrom: V3,
                     iray: V3, seed: torch.Tensor, sec, pack: bool = False):
    """Plain torch trace.  seed: int32 [n] (uint32 bits).  Returns
    (C4, dist), or (fb int32 BGRA bits, dist) with pack=True."""
    col, dist = trace_wave_env(wt, cfg, ifrom, iray, lcg.u32(seed), sec)
    return (col_ftoint(col), dist) if pack else (col, dist)


def _check_inputs(wt: TorchWorld, ifrom: V3, iray: V3, seed):
    n = ifrom.x.shape[0]
    for t in (*ifrom, *iray):
        if t.shape != (n,) or t.dtype != torch.float32:
            raise ValueError("ifrom/iray components must be float32 [n]")
    if seed.shape != (n,) or seed.dtype != torch.int32:
        raise ValueError("seed must be int32 [n] (uint32 bits)")
    tables = (wt.ent, wt.word, wt.sph, wt.bound)
    devs = {t.device for t in (*ifrom, *iray, seed, *tables)}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")
    if (wt.ent.shape != (4096,) or wt.word.shape != (4096,)
            or wt.sph.shape != (wt.n_spheres, SPH_COLS)
            or wt.bound.shape != (4,)
            or not all(t.is_contiguous() for t in tables)):
        raise ValueError("world tables do not have world_to_torch's "
                         "shapes and layout")


def _launch(wt: TorchWorld, cfg: RenderConfig, ifrom: V3, iray: V3,
            seed: torch.Tensor, sec):
    global LAUNCHES
    n = ifrom.x.shape[0]
    dev = ifrom.x.device
    ins = [t.contiguous() for t in (*ifrom, *iray)]
    seed = seed.contiguous()
    fb = torch.empty(n, dtype=torch.int32, device=dev)
    dist = torch.empty(n, dtype=torch.float32, device=dev)
    lib = _build.load("tracer", _SIGS)
    with torch.cuda.device(dev):
        err = lib.pwnfps_trace(
            *(t.data_ptr() for t in ins), seed.data_ptr(),
            wt.ent.data_ptr(), wt.word.data_ptr(), wt.sph.data_ptr(),
            wt.bound.data_ptr(),
            n, wt.n_spheres, cfg.maxsteps, cfg.reflect,
            int(cfg.space_skip and wt.skip_ok),
            float(np.float32(sec)), float(np.float32(wt.slack)),
            lcg.INV_MOD_F, fb.data_ptr(), dist.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"trace kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return fb, dist


def trace_wave(wt: TorchWorld, cfg: RenderConfig, ifrom: V3, iray: V3,
               seed: torch.Tensor, sec, pack: bool = False):
    """Full multi-bounce trace of n rays.  Returns (C4 of [n], dist [n]),
    or (fb int32 [n] BGRA bits, dist [n]) with pack=True.  The kernel
    writes packed BGRA only, so CUDA tensors need pack=True."""
    check_config(cfg)
    _check_inputs(wt, ifrom, iray, seed)
    dev = ifrom.x.device
    if dev.type == "cpu":
        return trace_wave_plain(wt, cfg, ifrom, iray, seed, sec, pack)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not pack:
        raise NotImplementedError("the trace kernel writes packed BGRA "
                                  "only: pass pack=True")
    return _launch(wt, cfg, ifrom, iray, seed, sec)
