"""Multi-bounce trace entry point (pwnfps_tpu/ops/tracer_jnp.py:
trace_wave and tracer_pallas.py:trace_wave_pallas).

`trace_wave_plain` runs the plain torch tracer (ops/tracer_core.py) on
any device.  `trace_wave` takes it for CPU tensors and launches the
CUDA kernel of csrc/tracer.cu for CUDA tensors: entry `pwnfps_trace`,
in fast mode or, when `cfg.parity` is set, in parity mode.  The kernel
replaces the TPU kernel pwnfps_tpu/ops/tracer_pallas.py:_kernel: one
page or a paged world in both modes, where every ray starts on the
scalar page `page0` (the TPU kernel's `page0_ref`, tracer_pallas.py:648).
In either mode `cfg.samples > 1` traces the primary wave once and
`samples` bounce chains from it, and writes their mean
(tracer_core.trace_wave_env).  `cfg.fused` in fast mode runs the fused
wave loop (tracer_core.run_fused), one sample; parity mode and profile
runs ignore it.  With pack=False every instance writes the colour
unpacked, four f32 planes in place of the BGRA word.

The measurement knobs (`cfg.profile`, `cfg.water=False`, `cfg.probe`)
run in every mode and combination the JAX package accepts (`instance`):
one knob in fast mode with one sample, unfused, launches its instance
of entry `pwnfps_trace_variant` (csrc/tracer_variants.cu), one knob in
parity mode with one sample its instance of `pwnfps_trace_parity_variant`
(csrc/tracer_parity_variants.cu), and every other combination (several
knobs, samples > 1, the fused loop) the instance of its structure that
reads the knobs at run time, `pwnfps_trace_flags` (csrc/tracer_flags.cu).
`trace_wave_profile` returns the per-wave terminal step counts beside the
frame, `trace_wave_phases` the phases instance's warp-cycles by region
(either mode, one sample, unfused).  Every entry takes one argument, the launch's
fields packed into csrc/tracer_body.cuh's `Args` (`_ARGS`), through the
port's launch route (`_launch.Entry`); a world's table checks and
addresses are kept after its first launch.

Each warp of every instance traces a tile of 32 rays: 8x4 pixels of
the row-major image `cfg.width` wide that the rays are taken to be
(where the width divides n), else 32 consecutive rays.  `warp_tiles`
is the kernel's map from a warp's tile to its rays; no output depends
on it.  The samples (either mode) and fused instances run persistent
warps that take tiles off a queue: a two-word scratch tensor a (device,
stream) pair, which each launch leaves zero.
"""

from __future__ import annotations

import ctypes
import dataclasses
import struct
import weakref

import numpy as np
import torch

from .._launch import Entry, stream as current_stream
from ..core import lcg
from ..core.approx import COMPACT_RCP, COMPACT_RSQ
from ..core.config import RenderConfig
from .tracer_core import (PROBES, check_config, col_ftoint, takes_fused,
                          trace_wave_env, variant)
from .vec import C4, V3
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
# (VAR_*), and their launches, one counter a variant, either kind of
# world: LAUNCHES_VARIANT fast mode's (tracer_variants.cu),
# LAUNCHES_PARITY_VARIANT parity mode's (tracer_parity_variants.cu)
VARIANTS = {name: k for k, name in enumerate(("nowater", "profile")
                                             + PROBES, 1)}
LAUNCHES_VARIANT = dict.fromkeys(VARIANTS, 0)
LAUNCHES_PARITY_VARIANT = dict.fromkeys(VARIANTS, 0)
# the instance of each structure that reads its knobs at run time
# (VAR_FLAGS, tracer_flags.cu; Args.flags: a probe's VAR_* in the low 4
# bits, FLAG_NOWATER), and its launches by structure, either kind of world
VAR_FLAGS, FLAG_NOWATER = 12, 16
STRUCTURES = ("fast", "samples", "fused", "parity", "parity_samples")
LAUNCHES_FLAGS = dict.fromkeys(STRUCTURES, 0)
# launches of the rendering instances with pack=False (the colour
# unpacked), by instance, each in this counter only
RENDERING = ("fast", "paged", "samples", "fused", "parity",
             "parity_samples", "parity_paged")
LAUNCHES_UNPACKED = dict.fromkeys(RENDERING, 0)
# the phases instance (VAR_PHASES: either mode, one sample): its regions
# in the order of its counters (csrc/tracer_body.cuh PH_*), the rows of
# counters it takes, and its launches
PHASES = ("prologue", "tile", "march", "steps", "shade", "unwind", "kernel")
VAR_PHASES, PHASE_ROWS = len(VARIANTS) + 1, 8192
LAUNCHES_PHASES = 0
# C entry points of csrc/tracer.cu, tracer_variants.cu,
# tracer_parity_variants.cu and tracer_flags.cu, each taking one packed
# argument: csrc/tracer_body.cuh's Args, 19 pointers, 16 int32 and 4
# float32 (struct packing rounds each float to f32)
_ARGS = struct.Struct("=19Q16i4f")
_TRACE = Entry("tracer", "pwnfps_trace", [ctypes.c_char_p])
_TRACE_VARIANT = Entry("tracer_variants", "pwnfps_trace_variant",
                       [ctypes.c_char_p])
_TRACE_PARITY_VARIANT = Entry("tracer_parity_variants",
                              "pwnfps_trace_parity_variant",
                              [ctypes.c_char_p])
_TRACE_FLAGS = Entry("tracer_flags", "pwnfps_trace_flags",
                     [ctypes.c_char_p])
# the kernel libraries of the tracer's entries
LIBRARIES = ("tracer", "tracer_variants", "tracer_parity_variants",
             "tracer_flags")
# a warp's tile: 8 x 4 pixels, one ray a lane (csrc/tracer_body.cuh)
WARP, TILE_W, TILE_H = 32, 8, 4
# the tile queue of each (device index, stream handle): the tensor and
# its address
_QUEUES: dict[tuple[int, int], tuple[torch.Tensor, int]] = {}
# each world whose tables passed _world_args's checks, by id: (a weak
# reference to it, its device index, its tables' addresses)
_WORLDS: dict[int, tuple] = {}


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


def _queue(index: int, stream: int) -> int:
    """The address of the tile queue of `stream` on device `index`."""
    q = _QUEUES.get((index, stream))
    if q is None:
        t = torch.zeros(2, dtype=torch.int32, device=torch.device("cuda",
                                                                  index))
        q = _QUEUES[(index, stream)] = (t, t.data_ptr())
    return q[1]


def instance(cfg: RenderConfig, n_pages: int) -> tuple[str, str]:
    """(entry, counter) of the kernel instance cfg selects: entry one of
    "tracer" (a rendering instance), "variant", "parity_variant" (one
    knob, one sample, unfused; the counter is the knob) or "flags" (the
    counter is the structure, STRUCTURES)."""
    var = variant(cfg)
    if not var:
        if cfg.parity:
            return "tracer", ("parity_paged" if n_pages > 1 else
                              "parity_samples" if cfg.samples > 1 else
                              "parity")
        if takes_fused(cfg):
            return "tracer", "fused"
        return "tracer", ("samples" if cfg.samples > 1 else
                          "paged" if n_pages > 1 else "fast")
    if len(var) == 1 and cfg.samples == 1 and not takes_fused(cfg):
        return ("parity_variant" if cfg.parity else "variant"), var[0]
    if takes_fused(cfg):
        return "flags", "fused"
    structure = "samples" if cfg.samples > 1 else "fast"
    if cfg.parity:
        structure = "parity" if structure == "fast" else "parity_samples"
    return "flags", structure


def _pack(wt: TorchWorld, cfg: RenderConfig, n: int, rays, outs, queue,
          sec, page0: int, width: int, var: str, out_col: int = 0) -> bytes:
    """The kernel's Args for a launch: rays the 7 input addresses, outs
    the (fb, dist, tstep) addresses (0: none), queue the tile queue's,
    var "phases" or the entry of `instance`, out_col the address of the
    unpacked colour (0: pack it)."""
    code, flags = 0, 0
    if var == "phases":
        code = VAR_PHASES
    elif var in ("variant", "parity_variant"):
        code = VARIANTS[variant(cfg)[0]]
    elif var == "flags":
        code = VAR_FLAGS
        flags = ((VARIANTS[cfg.probe] if cfg.probe else 0)
                 | (0 if cfg.water else FLAG_NOWATER))
    return _ARGS.pack(
        *rays, *_world_args(wt)[1], *outs, queue, 0, out_col,
        n, wt.n_spheres, wt.k_bucket, cfg.maxsteps, cfg.reflect,
        cfg.space_skip and wt.skip_ok, wt.n_pages, wt.sphere_page, page0,
        cfg.samples, takes_fused(cfg), max(1, cfg.step_chunk), width,
        cfg.parity, code, flags, sec, wt.slack, lcg.INV_MOD_F,
        1.0 / cfg.samples)


def launch_shape(cfg: RenderConfig, n: int, width: int | None,
                 n_pages: int, device) -> dict:
    """What the rendering instance cfg selects takes on `device` for n
    rays: dynamic shared memory bytes a block, resident blocks an SM,
    threads a block and the blocks of the launch (pwnfps_trace with its
    query set)."""
    out = torch.zeros(4, dtype=torch.int32)
    fused = cfg.fused and not cfg.parity
    args = _ARGS.pack(*[0] * 17, out.data_ptr(), 0, n, 0, 0, 0, cfg.reflect,
                      0, n_pages, 0, 0, cfg.samples, fused, 1, width or 0,
                      cfg.parity, 0, 0, 0.0, 0.0, 0.0, 0.0)
    index = torch.device(device).index or 0
    _TRACE.on(index, 0, args)
    return dict(zip(("smem_bytes", "blocks_per_sm", "threads", "blocks"),
                    out.tolist()))


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


def _world_args(wt: TorchWorld) -> tuple[int, tuple]:
    """(device index, -1 on the CPU, and the addresses of ent, word, sph,
    bound, buckets and sse, the SSE tables' compact form that the kernel
    reads in place of rsqrt_tab and rcp_tab) of a world whose tables have
    world_to_torch's shapes and layout, or ValueError.  Checked once a
    world: a TorchWorld is frozen, and its tables are not replaced."""
    hit = _WORLDS.get(id(wt))
    if hit is not None and hit[0]() is wt:
        return hit[1], hit[2]
    tables = (wt.ent, wt.word, wt.sph, wt.bound, wt.buckets, wt.sse)
    cells = wt.n_pages * 4096
    if (wt.ent.shape != (cells,) or wt.word.shape != (cells,)
            or not 0 <= wt.sphere_page < wt.n_pages
            or wt.sph.shape != (wt.n_spheres, SPH_COLS)
            or wt.bound.shape != (4,)
            or wt.buckets.shape != (cells * wt.k_bucket,)
            or wt.sse.shape != (COMPACT_RSQ + COMPACT_RCP,)
            or wt.sse.dtype != torch.int16
            or any(t.dtype != torch.int32
                   for t in (wt.ent, wt.word, wt.buckets))
            or not all(t.is_contiguous() for t in tables)):
        raise ValueError("world tables do not have world_to_torch's "
                         "shapes and layout")
    devs = {t.device for t in tables}
    if len(devs) != 1:
        raise ValueError(f"world tables on several devices: {devs}")
    key = id(wt)
    hit = _WORLDS[key] = (
        weakref.ref(wt, lambda _, key=key: _WORLDS.pop(key, None)),
        wt.ent.get_device(), tuple(t.data_ptr() for t in tables))
    return hit[1], hit[2]


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
    index = _world_args(wt)[0]
    if any(t.get_device() != index for t in (*ifrom, *iray, seed)):
        raise ValueError("rays, seeds and world tables on several "
                         "devices")


_ENTRIES = {"tracer": _TRACE, "variant": _TRACE_VARIANT,
            "parity_variant": _TRACE_PARITY_VARIANT, "flags": _TRACE_FLAGS}


def _launch(wt: TorchWorld, cfg: RenderConfig, ifrom: V3, iray: V3,
            seed: torch.Tensor, sec, page0: int, width: int | None = None,
            phases: bool = False, pack: bool = True):
    """Launch the instance cfg selects (`instance`), or with phases the
    phases instance; width: as trace_wave's.  Returns (fb, dist, tstep):
    fb int32 [n] BGRA bits, or with pack=False the C4 of f32 [n]; tstep
    int32 [n_waves, n] where cfg.profile records one, int64
    [PHASE_ROWS, len(PHASES)] from the phases instance, else None."""
    n = ifrom.x.shape[0]
    index = seed.get_device()
    # the contiguous copies must outlive the launch: keep them here
    keep = [t.contiguous() for t in (*ifrom, *iray, seed)]
    dist = torch.empty_like(keep[0])
    entry, key = ("phases", "") if phases else instance(cfg, wt.n_pages)
    fb = torch.empty_like(keep[6]) if pack else None
    col = None if pack else torch.empty((4, n), dtype=torch.float32,
                                        device=seed.device)
    tstep = (torch.zeros((PHASE_ROWS, len(PHASES)), dtype=torch.int64,
                         device=seed.device) if phases
             else _tstep(cfg, n, seed.device))
    _issue(wt, cfg, n, index, current_stream(index),
           [t.data_ptr() for t in keep],
           (fb.data_ptr() if pack else 0, dist.data_ptr(),
            tstep.data_ptr() if tstep is not None else 0),
           sec, page0, cfg.width if width is None else width, entry, key,
           0 if pack else col.data_ptr())
    return (fb if pack else C4(*col)), dist, tstep


def _tstep(cfg: RenderConfig, n: int, device):
    """The int32 [n_waves, n] per-wave step counts cfg.profile records,
    or None."""
    if "profile" not in variant(cfg):
        return None
    return torch.empty((cfg.n_waves, n), dtype=torch.int32, device=device)


def _issue(wt: TorchWorld, cfg: RenderConfig, n: int, index: int,
           stream: int, rays, outs, sec, page0: int, width: int,
           entry: str, key: str, out_col: int = 0) -> None:
    """Pack the Args of one launch (see _pack) and launch `entry`, the
    instance `key` of `instance` or "phases", on `stream` of device
    `index`, counting it."""
    global LAUNCHES, LAUNCHES_PAGED, LAUNCHES_SAMPLES, LAUNCHES_FUSED, \
        LAUNCHES_PARITY, LAUNCHES_PARITY_SAMPLES, LAUNCHES_PARITY_PAGED, \
        LAUNCHES_PHASES
    args = _pack(wt, cfg, n, rays, outs, _queue(index, stream), sec, page0,
                 width, entry, out_col)
    if entry == "phases":
        _TRACE_VARIANT.on(index, stream, args)
        LAUNCHES_PHASES += 1
        return
    _ENTRIES[entry].on(index, stream, args)
    if entry == "variant":
        LAUNCHES_VARIANT[key] += 1
    elif entry == "parity_variant":
        LAUNCHES_PARITY_VARIANT[key] += 1
    elif entry == "flags":
        LAUNCHES_FLAGS[key] += 1
    elif out_col:
        LAUNCHES_UNPACKED[key] += 1
    elif key == "parity_paged":
        LAUNCHES_PARITY_PAGED += 1
    elif key == "parity_samples":
        LAUNCHES_PARITY_SAMPLES += 1
    elif key == "parity":
        LAUNCHES_PARITY += 1
    elif key == "fused":
        LAUNCHES_FUSED += 1
    elif key == "samples":
        LAUNCHES_SAMPLES += 1
    elif key == "paged":
        LAUNCHES_PAGED += 1
    else:
        LAUNCHES += 1


def trace_planes(wt: TorchWorld, cfg: RenderConfig, n: int, index: int,
                 stream: int, rays, fb: int, dist: int, sec,
                 page0: int = 0) -> None:
    """trace_wave(pack=True) of a row-major cfg.width-wide image of n
    rays on planes the caller allocated on CUDA device `index`, launched
    on `stream`: rays the addresses of the 7 input planes (ifrom x, y, z,
    iray x, y, z, seed; n values each, as csrc/rays.cu writes them), fb
    and dist those of the int32 BGRA and f32 outputs.  The planes are
    not checked: render_frame's route, which allocates nothing here but
    the step counts cfg.profile records (dropped, as trace_wave drops
    them)."""
    check_config(cfg)
    if cfg.samples < 1:
        raise ValueError(f"samples={cfg.samples}: need at least one")
    if not 0 <= page0 < wt.n_pages:
        raise ValueError(f"start page {page0} is not a page of a "
                         f"{wt.n_pages}-page world")
    entry, key = instance(cfg, wt.n_pages)
    tstep = _tstep(cfg, n, wt.device)
    _issue(wt, cfg, n, index, stream, rays,
           (fb, dist, tstep.data_ptr() if tstep is not None else 0),
           sec, page0, cfg.width, entry, key)


def trace_wave(wt: TorchWorld, cfg: RenderConfig, ifrom: V3, iray: V3,
               seed: torch.Tensor, sec, pack: bool = False, page0: int = 0,
               width: int | None = None):
    """Full multi-bounce trace of n rays, each starting on page `page0`,
    averaged over cfg.samples bounce chains.  Returns (C4 of [n], dist
    [n]), or (fb int32 [n] BGRA bits, dist [n]) with pack=True; on CUDA
    tensors the kernel packs the colour, or writes it unpacked.
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
    return _launch(wt, cfg, ifrom, iray, seed, sec, page0, width,
                   pack=pack)[:2]


def trace_wave_profile(wt: TorchWorld, cfg: RenderConfig, ifrom: V3,
                       iray: V3, seed: torch.Tensor, sec, page0: int = 0):
    """trace_wave with cfg.profile set: (fb int32 [n] BGRA bits, dist
    [n], tstep int32 [n_waves, n]), each wave's terminal DDA step count
    a ray (tracer_core.run_segment; 0 for a wave the ray's chain never
    reached), in either mode with one sample and with the other knobs
    cfg sets.  The kernel-granular counterpart of reading SegOut.tstep
    per wave in the JAX package (tools/occupancy.py).  With samples > 1
    the JAX package has no per-wave tstep (each sample's chain has its
    own waves), so that raises ValueError."""
    cfg = dataclasses.replace(cfg, profile=True)
    check_config(cfg)
    if cfg.samples != 1:
        raise ValueError(f"samples={cfg.samples}: a per-wave tstep exists "
                         "for one sample only (the JAX package records "
                         "none for its sample chains)")
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


def trace_wave_phases(wt: TorchWorld, cfg: RenderConfig, ifrom: V3,
                      iray: V3, seed: torch.Tensor, sec, page0: int = 0,
                      width: int | None = None):
    """trace_wave with one sample, unfused, in either mode, through the
    phases instance, CUDA tensors only: (fb int32 [n] BGRA bits, dist
    [n], cycles int64 [len(PHASES)]), the warps' clock64() cycles in each
    region of PHASES, summed over the warps.  A region counts once a warp
    each time the warp runs it (its lowest active lane times it).  The
    counters slow the kernel; fb and dist are the one-chain instance's."""
    check_config(cfg)
    if cfg.samples != 1 or takes_fused(cfg) or variant(cfg):
        raise ValueError("the phases instance traces one sample, unfused, "
                         "no other measurement instance")
    _check_inputs(wt, ifrom, iray, seed, page0)
    if ifrom.x.device.type != "cuda":
        raise ValueError(f"unsupported device {ifrom.x.device}: the "
                         "phases instance runs on the card")
    fb, dist, cycles = _launch(wt, cfg, ifrom, iray, seed, sec, page0,
                               width, phases=True)
    return fb, dist, cycles.sum(0)
