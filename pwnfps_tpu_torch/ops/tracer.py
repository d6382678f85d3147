"""Multi-bounce trace entry point (pwnfps_tpu/ops/tracer_jnp.py:
trace_wave and tracer_pallas.py:trace_wave_pallas).

`trace_wave_plain` runs the plain torch tracer (ops/tracer_core.py) on
any device.  `trace_wave` takes it for CPU tensors and launches the
CUDA kernel of csrc/tracer.cu for CUDA tensors: entry `pwnfps_trace` in
fast mode, `pwnfps_trace_parity` when `cfg.parity` is set.  The kernel
replaces the TPU kernel pwnfps_tpu/ops/tracer_pallas.py:_kernel: one
page or a paged world in both modes, where every ray starts on the
scalar page `page0` (the TPU kernel's `page0_ref`, tracer_pallas.py:648).
In either mode `cfg.samples > 1` traces the primary wave once and
`samples` bounce chains from it, and writes their mean
(tracer_core.trace_wave_env).  `cfg.fused` in fast mode runs the fused
wave loop (tracer_core.run_fused), one sample; parity mode ignores it.

The measurement instances (`cfg.profile`, `cfg.water=False`, `cfg.probe`;
fast mode, one sample, unfused, one page or paged) launch entry
`pwnfps_trace_variant` of csrc/tracer_variants.cu, one instance of the
same template each.  `trace_wave_profile` returns the profile instance's
per-wave terminal step counts beside the frame.

Each warp of every instance traces a tile of 32 rays: 8x4 pixels of
the row-major image `cfg.width` wide that the rays are taken to be
(where the width divides n), else 32 consecutive rays.  `warp_tiles`
is the kernel's map from a warp's tile to its rays; no output depends
on it.  The parity, samples and fused
instances run persistent warps that take tiles off a queue: a two-word
scratch tensor a (device, stream) pair, which each launch leaves zero.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from .. import _build
from ..core import lcg
from ..core.config import RenderConfig
from .tracer_core import (PROBES, check_config, col_ftoint,
                          trace_wave_env, variant)
from .vec import V3
from .world import SPH_COLS, TorchWorld

# launches of each kernel variant since import (reset by callers that
# count), each launch in one counter: LAUNCHES fast mode on a one-page
# world, LAUNCHES_PAGED fast mode on a paged world (the same entry),
# LAUNCHES_SAMPLES fast mode with cfg.samples > 1 (the same entry, on
# either kind of world), LAUNCHES_FUSED the fused wave loop (fast mode,
# either kind of world), LAUNCHES_PARITY parity mode on a one-page world
# with one sample, LAUNCHES_PARITY_SAMPLES parity mode on a one-page world
# with cfg.samples > 1, LAUNCHES_PARITY_PAGED parity mode on a paged world
# with any number of samples (the same entry)
LAUNCHES = 0
LAUNCHES_PAGED = 0
LAUNCHES_SAMPLES = 0
LAUNCHES_FUSED = 0
LAUNCHES_PARITY = 0
LAUNCHES_PARITY_SAMPLES = 0
LAUNCHES_PARITY_PAGED = 0
# the measurement instances' template values in csrc/tracer_body.cuh
# (VAR_*), and their launches, one counter a variant, either kind of world
VARIANTS = {name: k for k, name in enumerate(("nowater", "profile")
                                             + PROBES, 1)}
LAUNCHES_VARIANT = dict.fromkeys(VARIANTS, 0)
# C entry points of csrc/tracer.cu and csrc/tracer_variants.cu
_TAIL = [ctypes.c_int, ctypes.c_void_p]     # width, stream
_QTAIL = [ctypes.c_int] + [ctypes.c_void_p] * 2    # width, queue, stream
_SIGS = {"pwnfps_trace": [ctypes.c_void_p] * 11 + [ctypes.c_int] * 11
         + [ctypes.c_float] * 4 + [ctypes.c_void_p] * 2 + _QTAIL,
         "pwnfps_trace_parity": [ctypes.c_void_p] * 13 + [ctypes.c_int] * 9
         + [ctypes.c_float] * 3 + [ctypes.c_void_p] * 2 + _QTAIL,
         "pwnfps_trace_query": [ctypes.c_int] * 7 + [ctypes.c_void_p]}
_SIGS_VARIANTS = {"pwnfps_trace_variant": [ctypes.c_void_p] * 11
                  + [ctypes.c_int] * 9 + [ctypes.c_float] * 3
                  + [ctypes.c_void_p] * 3 + _TAIL}
# a warp's tile: 8 x 4 pixels, one ray a lane (csrc/tracer_body.cuh)
WARP, TILE_W, TILE_H = 32, 8, 4
# the tile queue of each (device index, stream handle)
_QUEUES: dict[tuple[int, int], torch.Tensor] = {}


def warp_tiles(n: int, width: int | None = None) -> np.ndarray:
    """The kernel's warps: [n_tiles, 32] int64, the ray each lane of
    each tile traces, -1 for a masked lane (csrc/tracer_body.cuh
    tile_ray).  For n rays of a row-major image `width` wide (width
    divides n) the tiles are 8x4 pixels, row-major, the last row and
    column of tiles ragged; else runs of 32 consecutive rays."""
    if not width or n % width:
        idx = np.arange(-(-n // WARP) * WARP)
        return np.where(idx < n, idx, -1).reshape(-1, WARP)
    rows = n // width
    tiles_x = -(-width // TILE_W)
    tile = np.arange(tiles_x * -(-rows // TILE_H))[:, None]
    lane = np.arange(WARP)[None, :]
    x = tile % tiles_x * TILE_W + lane % TILE_W
    y = tile // tiles_x * TILE_H + lane // TILE_W
    return np.where((x < width) & (y < rows), y * width + x, -1)


def _queue(dev: torch.device, stream: int) -> torch.Tensor:
    q = _QUEUES.get((dev.index, stream))
    if q is None:
        q = _QUEUES[(dev.index, stream)] = torch.zeros(
            2, dtype=torch.int32, device=dev)
    return q


def launch_shape(cfg: RenderConfig, n: int, width: int | None,
                 n_pages: int, device) -> dict:
    """What the rendering instance cfg selects takes on `device` for n
    rays: dynamic shared memory bytes a block, resident blocks an SM,
    threads a block and the blocks of the launch (pwnfps_trace_query)."""
    lib = _build.load("tracer", _SIGS)
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device):
        err = lib.pwnfps_trace_query(
            int(cfg.parity), n, width or 0, cfg.reflect, n_pages,
            cfg.samples, int(cfg.fused and not cfg.parity),
            ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"trace kernel query failed: CUDA error {err}")
    return dict(zip(("smem_bytes", "blocks_per_sm", "threads", "blocks"),
                    out))


def trace_wave_plain(wt: TorchWorld, cfg: RenderConfig, ifrom: V3,
                     iray: V3, seed: torch.Tensor, sec, pack: bool = False,
                     counts: dict | None = None, page0: int = 0,
                     segs: list | None = None):
    """Plain torch trace.  seed: int32 [n] (uint32 bits); page0: the
    page every ray starts on.  Returns (C4, dist), or (fb int32 BGRA
    bits, dist) with pack=True.  counts: see tracer_core.run_segment;
    segs: see tracer_core.trace_wave_env."""
    page = torch.full_like(seed, page0)
    col, dist = trace_wave_env(wt, cfg, ifrom, iray, lcg.u32(seed), sec,
                               page, counts, segs)
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
            seed: torch.Tensor, sec, page0: int, width: int | None = None):
    """Launch the instance cfg selects; width: as trace_wave's.  Returns
    (fb, dist, tstep): tstep int32 [n_waves, n] from the profile
    instance, else None."""
    global LAUNCHES, LAUNCHES_PAGED, LAUNCHES_SAMPLES, LAUNCHES_FUSED, \
        LAUNCHES_PARITY, LAUNCHES_PARITY_SAMPLES, LAUNCHES_PARITY_PAGED
    n = ifrom.x.shape[0]
    dev = ifrom.x.device
    # the contiguous copies must outlive the launch: keep them here
    keep = [t.contiguous() for t in (*ifrom, *iray, seed)]
    ins = [t.data_ptr() for t in keep]
    fb = torch.empty(n, dtype=torch.int32, device=dev)
    dist = torch.empty(n, dtype=torch.float32, device=dev)
    tstep = None
    stream = torch.cuda.current_stream(dev).cuda_stream
    width = cfg.width if width is None else width
    tail = (width, stream)
    qtail = (width, _queue(dev, stream).data_ptr(), stream)
    inv = float(np.float32(1.0 / cfg.samples))
    fused = cfg.fused and not cfg.parity
    var = variant(cfg)
    if var:
        lib = _build.load("tracer_variants", _SIGS_VARIANTS)
        if var == "profile":
            tstep = torch.empty((cfg.n_waves, n), dtype=torch.int32,
                                device=dev)
        with torch.cuda.device(dev):
            err = lib.pwnfps_trace_variant(
                *ins, wt.ent.data_ptr(), wt.word.data_ptr(),
                wt.sph.data_ptr(), wt.bound.data_ptr(),
                n, wt.n_spheres, cfg.maxsteps, cfg.reflect,
                int(cfg.space_skip and wt.skip_ok), wt.n_pages,
                wt.sphere_page, page0, VARIANTS[var],
                float(np.float32(sec)), float(np.float32(wt.slack)),
                lcg.INV_MOD_F, fb.data_ptr(), dist.data_ptr(),
                tstep.data_ptr() if tstep is not None else None, *tail)
        if err != 0:
            raise RuntimeError(f"trace kernel ({var}) launch failed: CUDA "
                               f"error {err}")
        LAUNCHES_VARIANT[var] += 1
        return fb, dist, tstep
    lib = _build.load("tracer", _SIGS)
    with torch.cuda.device(dev):
        if cfg.parity:
            err = lib.pwnfps_trace_parity(
                *ins, wt.ent.data_ptr(), wt.word.data_ptr(),
                wt.sph.data_ptr(), wt.buckets.data_ptr(),
                wt.rsqrt_tab.data_ptr(), wt.rcp_tab.data_ptr(),
                n, wt.n_spheres, wt.k_bucket, cfg.maxsteps, cfg.reflect,
                wt.n_pages, wt.sphere_page, page0, cfg.samples,
                float(np.float32(sec)), lcg.INV_MOD_F, inv,
                fb.data_ptr(), dist.data_ptr(), *qtail)
        else:
            err = lib.pwnfps_trace(
                *ins, wt.ent.data_ptr(), wt.word.data_ptr(),
                wt.sph.data_ptr(), wt.bound.data_ptr(),
                n, wt.n_spheres, cfg.maxsteps, cfg.reflect,
                int(cfg.space_skip and wt.skip_ok), wt.n_pages,
                wt.sphere_page, page0, cfg.samples, int(fused),
                max(1, cfg.step_chunk), float(np.float32(sec)),
                float(np.float32(wt.slack)), lcg.INV_MOD_F, inv,
                fb.data_ptr(), dist.data_ptr(), *qtail)
    if err != 0:
        raise RuntimeError(f"trace kernel launch failed: CUDA error {err}")
    if cfg.parity and wt.n_pages > 1:
        LAUNCHES_PARITY_PAGED += 1
    elif cfg.parity and cfg.samples > 1:
        LAUNCHES_PARITY_SAMPLES += 1
    elif cfg.parity:
        LAUNCHES_PARITY += 1
    elif fused:
        LAUNCHES_FUSED += 1
    elif cfg.samples > 1:
        LAUNCHES_SAMPLES += 1
    elif wt.n_pages > 1:
        LAUNCHES_PAGED += 1
    else:
        LAUNCHES += 1
    return fb, dist, tstep


def trace_wave(wt: TorchWorld, cfg: RenderConfig, ifrom: V3, iray: V3,
               seed: torch.Tensor, sec, pack: bool = False, page0: int = 0,
               width: int | None = None):
    """Full multi-bounce trace of n rays, each starting on page `page0`,
    averaged over cfg.samples bounce chains.  Returns (C4 of [n], dist
    [n]), or (fb int32 [n] BGRA bits, dist [n]) with pack=True.  The
    kernel writes packed BGRA only, so CUDA tensors need pack=True.
    width: the rays are a row-major image (or stacked images) this wide,
    which the kernel's warps take in 8x4-pixel tiles, by default
    cfg.width; 0 for rays that are no image (32 consecutive rays a
    warp).  The results do not depend on it."""
    check_config(cfg)
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
    return _launch(wt, cfg, ifrom, iray, seed, sec, page0, width)[:2]


def trace_wave_profile(wt: TorchWorld, cfg: RenderConfig, ifrom: V3,
                       iray: V3, seed: torch.Tensor, sec, page0: int = 0):
    """trace_wave with cfg.profile set: (fb int32 [n] BGRA bits, dist
    [n], tstep int32 [n_waves, n]), each wave's terminal DDA step count
    a ray (tracer_core.run_segment; 0 for a wave the ray's chain never
    reached).  The kernel-granular counterpart of reading SegOut.tstep
    per wave in the JAX package (tools/occupancy.py)."""
    cfg = dataclasses.replace(cfg, profile=True)
    check_config(cfg)
    _check_inputs(wt, ifrom, iray, seed, page0)
    dev = ifrom.x.device
    if dev.type == "cpu":
        segs = []
        fb, dist = trace_wave_plain(wt, cfg, ifrom, iray, seed, sec, True,
                                    page0=page0, segs=segs)
        return fb, dist, torch.stack([o.tstep for o in segs])
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return _launch(wt, cfg, ifrom, iray, seed, sec, page0)
