"""Frame renderer (pwnfps_tpu/render/frame.py).

ray gen -> multi-bounce trace with in-kernel BGRA8 pack -> DoF blur.
On a CUDA device each of the three is one kernel launch (csrc/rays.cu,
ops/tracer.py, ops/blur.py) on planes of two blocks allocated once a
frame, and a frame waits on no stream synchronisation; on the CPU all
three take their plain torch versions (`gen_rays`, `pixel_seeds`, the
origin broadcast).  Fast mode
and parity mode (`cfg.parity`) on one page; fast mode on a paged world,
every primary ray starting on `cfg.cam_page`.  `render_accumulated` is
the multi-sample frame (BASELINE config #5), in either mode: the trace
averages `samples` bounce chains a pixel in the same one launch.

On a CUDA device a frame runs on the device's render stream, one stream
the module owns a device, and not on the caller's current stream: what
the caller queues after one frame, such as the copy of its framebuffer
to the host, then runs beside the next frame's kernels.  The render
stream waits on the caller's stream only where the frame's inputs may
have been written there since it last did: on another world, or on one
whose tensors were written in place (`must_join`); the camera, the clock
and the configuration come by value.  The caller's stream waits on the
frame before the call returns, so the returned tensors are ordered on
the caller's current stream as any tensor made there.
"""

from __future__ import annotations

import ctypes
import dataclasses
import operator
import struct
import weakref

import numpy as np
import torch

from .._launch import Entry
from ..core import lcg
from ..core.config import RenderConfig
from ..ops.blur import blur_planes, dof_blur
from ..ops.tracer import trace_planes, trace_wave
from ..ops.vec import V3
from ..ops.world import TorchWorld
from ..ops.worlddev import WorldMeta

# launches of csrc/rays.cu's kernel since import (reset by callers that
# count): one a frame_rays call on a CUDA device, none on the CPU
LAUNCHES_RAYS = 0
# csrc/rays.cu's C entry, taking one packed argument, its RayArgs: the 7
# output addresses (origin x, y, z, direction x, y, z, seed), n, width,
# height, parity, and the 12 floats of origin, rayb, rdx and rdy
_RAY_ARGS = struct.Struct("=7Q4i12f")
_RAYS = Entry("rays", "pwnfps_frame_rays", [ctypes.c_char_p])
# frames queued on a render stream since import, and the times a render
# stream waited on its caller's stream (must_join); reset by callers that
# count
FRAMES_SIDE = 0
STREAM_JOINS = 0
# device index -> its _RenderStream, made at the device's first frame
_RENDER: dict = {}


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


def _host_f32(v) -> np.ndarray:
    """A camera vector as float32 [3] on the host; a CUDA tensor is read
    back, which synchronises."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
    return np.asarray(v, np.float32).reshape(3)


def _camera(origin, rayb, rdx, rdy) -> list:
    """The 12 floats of a frame's camera vectors, read to the host."""
    return np.concatenate([_host_f32(v)
                           for v in (origin, rayb, rdx, rdy)]).tolist()


def _pack_rays(cfg: RenderConfig, outs, cam: list) -> bytes:
    return _RAY_ARGS.pack(*outs, cfg.width * cfg.height, cfg.width,
                          cfg.height, int(cfg.parity), *cam)


def ray_args(cfg: RenderConfig, origin, rayb, rdx, rdy, outs) -> bytes:
    """csrc/rays.cu's RayArgs for cfg's frame: outs the 7 output
    addresses, the camera vectors passed by value."""
    return _pack_rays(cfg, outs, _camera(origin, rayb, rdx, rdy))


def _launch_rays(cfg: RenderConfig, origin, rayb, rdx, rdy,
                 device: torch.device):
    global LAUNCHES_RAYS
    n = cfg.width * cfg.height
    planes = torch.empty((6, n), dtype=torch.float32,
                         device=device).unbind(0)
    seeds = torch.empty(n, dtype=torch.int32, device=device)
    outs = [t.data_ptr() for t in (*planes, seeds)]
    _RAYS(seeds.get_device(), ray_args(cfg, origin, rayb, rdx, rdy, outs))
    LAUNCHES_RAYS += 1
    return V3(*planes[:3]), V3(*planes[3:]), seeds


def frame_rays(cfg: RenderConfig, origin, rayb, rdx, rdy, device):
    """(ifrom V3, rays V3, seeds int32) of a frame's h*w primary rays on
    `device`: the camera origin broadcast, gen_rays and pixel_seeds.  On
    a CUDA device one launch of csrc/rays.cu's kernel writes all seven
    planes, bit-equal to the plain functions, with the camera vectors
    passed by value: no copy to the device and no synchronisation, but
    for a camera vector that is a CUDA tensor, which is read to the host
    first (that synchronises).  On the CPU the plain functions run."""
    device = torch.device(device)
    if device.type == "cuda":
        return _launch_rays(cfg, origin, rayb, rdx, rdy, device)
    return frame_rays_plain(cfg, origin, rayb, rdx, rdy, device)


def frame_rays_plain(cfg: RenderConfig, origin, rayb, rdx, rdy, device):
    """frame_rays by the plain functions on any device (gen_rays,
    pixel_seeds, the origin broadcast): the CPU path, and the
    counterpart the ray kernel is held against on the card."""
    h, w = cfg.height, cfg.width
    rays = gen_rays(_vec3(rayb, device), _vec3(rdx, device),
                    _vec3(rdy, device), w, h, cfg.parity)
    o = _vec3(origin, device)
    ifrom = V3(*(o[i].expand(h * w).contiguous() for i in range(3)))
    return ifrom, rays, pixel_seeds(w, h, device)


def render_frame(world: TorchWorld, meta: WorldMeta, cfg: RenderConfig,
                 origin, rayb, rdx, rdy, sec):
    """-> (framebuffer [h, w] int32 holding uint32 BGRA, zbuf [h, w] f32),
    on the world's device.  origin/rayb/rdx/rdy: float32 [3] (numpy or
    tensors, as render/camera.camera_vectors gives them; on a CUDA device
    numpy, or CPU tensors, keep the frame free of synchronisation, see
    frame_rays); sec: the clock.  On a CUDA device the frame runs on the
    device's render stream, and the results are ordered on the caller's
    current stream (see the module docstring).
    """
    if not 0 <= cfg.cam_page < meta.n_pages:
        raise ValueError(f"cam_page {cfg.cam_page} is not a page of a "
                         f"{meta.n_pages}-page world")
    if world.device.type == "cuda":
        return _render_cuda(world, cfg, origin, rayb, rdx, rdy, sec)
    h, w = cfg.height, cfg.width
    ifrom, rays, seeds = frame_rays(cfg, origin, rayb, rdx, rdy,
                                    world.device)
    fb, zbuf = trace_wave(world, cfg, ifrom, rays, seeds, sec, pack=True,
                          page0=cfg.cam_page)
    fb, zbuf = fb.reshape(h, w), zbuf.reshape(h, w)
    if cfg.postproc_blur:
        fb = dof_blur(fb, zbuf, cfg.postproc_blur)
    return fb, zbuf


# absent from a CPU-only torch, which queues nothing on a render stream
_stream_ids = getattr(torch._C, "_cuda_getCurrentStream", None)
_set_stream = getattr(torch._C, "_cuda_setStream", None)
_get_device = getattr(torch._C, "_cuda_getDevice", None)
# the tensors of a TorchWorld, whose version counters join_key holds
WORLD_TENSORS = ("ent", "word", "sph", "bound", "buckets", "rsqrt_tab",
                 "rcp_tab", "sse")
_world_tensors = operator.attrgetter(*WORLD_TENSORS)


class _RenderStream:
    """A device's render stream (and its ids, as torch names a stream),
    the event its last frame recorded there, the join_key of its last
    wait on a caller's stream, and the callers' streams by their ids."""

    __slots__ = ("stream", "ids", "handle", "done", "key", "callers")

    def __init__(self, index: int):
        s = self.stream = torch.cuda.Stream(index)
        self.ids = (s.stream_id, s.device_index, s.device_type)
        self.handle = s.cuda_stream
        self.done = torch.cuda.Event()
        self.key = None
        self.callers = {}

    def caller(self, index: int):
        """(the current stream of device `index`, its ids).  The Stream is
        built once for each stream seen: building one, as
        torch.cuda.current_stream does, took the host of an H100 machine
        ~5 us a call."""
        ids = _stream_ids(index)
        s = self.callers.get(ids)
        if s is None:
            s = self.callers[ids] = torch.cuda.Stream(
                stream_id=ids[0], device_index=ids[1], device_type=ids[2])
        return s, ids


def _versions(world: TorchWorld) -> tuple:
    return tuple(t._version for t in _world_tensors(world))


def join_key(world: TorchWorld) -> tuple:
    """What must_join compares: the world, held weakly, and the version
    counters of its tensors, which an in-place write moves."""
    return weakref.ref(world), _versions(world)


def must_join(world: TorchWorld, last) -> bool:
    """Whether a frame of `world` must wait on its caller's stream: the
    world may have been written there since the join whose join_key is
    `last` (None: no join yet): it is another world, or one of its
    tensors has been written in place since.  A world is written on a
    stream only when it is built and by in-place writes."""
    return (last is None or last[0]() is not world
            or last[1] != _versions(world))


def _render_cuda(world: TorchWorld, cfg: RenderConfig, origin, rayb, rdx,
                 rdy, sec):
    """render_frame on a CUDA device: the ray kernel, the tracer and each
    DoF pass launched by address on the device's render stream, on the
    rows of two int32 blocks allocated once a frame while the render
    stream is the current stream, so that the caching allocator ties
    them to it.  The scratch block holds the 7 ray planes, then the
    tracer's colour and each pass's output but the last; the output
    block [2, h, w] the delivered framebuffer and the depth, which the
    returned tensors are views of.

    The render stream first waits on the caller's current stream where
    must_join says so; the caller's stream then waits on the frame's last
    launch, and the output block is marked in use there
    (`record_stream`), so that no later frame takes it while the caller
    still reads it.  The current stream is set and restored by its ids:
    torch.cuda.stream() took the host of an H100 machine ~15 us."""
    global LAUNCHES_RAYS, FRAMES_SIDE, STREAM_JOINS
    h, w = cfg.height, cfg.width
    n, passes = h * w, cfg.postproc_blur
    dev = world.device
    index = dev.index
    rs = _RENDER.get(index)
    if rs is None:
        rs = _RENDER[index] = _RenderStream(index)
    caller, ids = rs.caller(index)
    # read on the caller's stream, which wrote any camera tensor
    cam = _camera(origin, rayb, rdx, rdy)
    if must_join(world, rs.key):
        rs.stream.wait_stream(caller)
        rs.key = join_key(world)
        STREAM_JOINS += 1
    stream, prev = rs.handle, _get_device()
    # makes device `index` current too
    _set_stream(stream_id=rs.ids[0], device_index=rs.ids[1],
                device_type=rs.ids[2])
    try:
        scratch = torch.empty((7 + passes, n), dtype=torch.int32,
                              device=dev)
        out = torch.empty((2, h, w), dtype=torch.int32, device=dev)
        row, s0, o0 = 4 * n, scratch.data_ptr(), out.data_ptr()
        rays = [s0 + k * row for k in range(7)]
        _RAYS.on(index, stream, _pack_rays(cfg, rays, cam))
        LAUNCHES_RAYS += 1
        fb = s0 + 7 * row if passes else o0
        trace_planes(world, cfg, n, index, stream, rays, fb, o0 + row, sec,
                     cfg.cam_page)
        for p in range(passes):
            dst = o0 if p == passes - 1 else s0 + (8 + p) * row
            blur_planes(dev, stream, fb, o0 + row, dst, h, w)
            fb = dst
        rs.done.record(rs.stream)
    finally:
        _set_stream(stream_id=ids[0], device_index=ids[1],
                    device_type=ids[2])
        if prev != index:
            torch.cuda.set_device(prev)
    caller.wait_event(rs.done)
    out.record_stream(caller)
    FRAMES_SIDE += 1
    return out[0], out[1].view(torch.float32)


def render_accumulated(world: TorchWorld, meta: WorldMeta,
                       cfg: RenderConfig, origin, rayb, rdx, rdy, sec,
                       samples: int = 4):
    """Distribution path tracing (pwnfps_tpu/render/frame.py:186-218):
    the mean of `samples` chains a pixel, whose reflect jitter draws from
    the seed streams pixel_seed + k*0x9E3779B9, sharing the primary wave.
    Fast mode or parity mode (cfg.parity, where each chain is the
    pixel-exact parity chain), on a one-page or a paged world.  Returns
    (fb [h, w] int32 BGRA of the mean, zbuf [h, w] of the primary wave),
    with cfg.postproc_blur DoF passes on that zbuf."""
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
