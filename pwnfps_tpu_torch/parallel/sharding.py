"""Camera batches and multi-device rendering
(pwnfps_tpu/parallel/sharding.py).

`render_cameras` renders C viewpoints of one world a step, as RL-style
rollouts do (BASELINE config #4): ray generation for every camera on
the device, one trace over all C x h x w rays and, with
`cfg.postproc_blur`, one blur launch a pass over the C stacked frames,
each blurred within its own rows.  On CUDA tensors the trace and the
blur are the kernels of ops/tracer.py and ops/blur.py; on CPU tensors
their plain versions.

With a `Mesh` of more than one device, the same batch is sharded as
the JAX package shards it: cameras over the "cam" axis, each camera's
rows over "px" (`render_cameras(..., mesh)`), and `render_frame_sharded`
splits one camera's frame over every device of the mesh.  Where the
frame is tall enough (`_band_rows`) each device traces contiguous row
bands of its own, one trace launch each, and blurs them after a halo
exchange with its neighbours (`_dof_blur_mesh`, the band kernel); a
shorter frame takes the flat path, whose trace splits the row-major ray
batch and whose blur bands are cut from the gathered frame.  JAX drives
its devices from one process with `shard_map` and `ppermute`; here one
process holds a list of torch devices and moves the halos with tensor
copies between them.  A device may repeat (`["cpu"] * 8` in the tests,
`["cuda:0"] * 8` on one card): the code is the same, and a copy onto
the same device is a slice.
"""

from __future__ import annotations

import dataclasses
from math import prod

import numpy as np
import torch

from ..core import lcg
from ..core.config import RenderConfig
from ..ops.blur import _fstr, dof_blur, dof_blur_band
from ..ops.tracer import trace_wave
from ..ops.vec import V3
from ..ops.world import TorchWorld, world_to_torch
from ..ops.worlddev import WorldMeta
from ..render.frame import _vec3, gen_rays, pixel_seeds

F32 = np.float32
AXES = ("cam", "px")
# blur band rows (blur_pallas.BR) and the band blur's tap reach in rows
# (blur_pallas.RR): the halo is at most RR rows, and a frame whose reach
# is not under RR - 0.5 takes the gathered fallback
BR = 8
RR = 48
# dead-ray fills of pad rows, in the order origin x, y, z, ray x, y, z,
# seed: origin (1, .5, 1) sits inside a wall cell, the ray dies on its
# first step (sharding.py:88)
_FILLS = dict(fx=1.0, fy=0.5, fz=1.0, rx=0.5, ry=-0.5, rz=0.5, seed=1)

# counted since import (reset by callers that count): FALLBACKS, blur
# passes the mesh blur ran gathered because the reach exceeded the
# halo; EXCHANGE_BYTES, halo bytes copied from a neighbour's band
FALLBACKS = 0
EXCHANGE_BYTES = 0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A [n_cam][n_px] grid of torch devices, repeats allowed (jax's
    Mesh with axes ("cam", "px")).  Position k = cam * n_px + px."""
    devices: tuple

    axis_names = AXES

    @property
    def shape(self) -> dict:
        return {"cam": len(self.devices), "px": len(self.devices[0])}

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])

    @property
    def flat(self) -> list:
        return [d for row in self.devices for d in row]


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(n_cam: int, n_px: int, devices=None) -> Mesh:
    """(sharding.py:35) devices: n_cam * n_px devices (names or
    torch.device), cam-major; None: every visible card."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [_device(d) for d in devices]
    if n_cam < 1 or n_px < 1 or len(devices) != n_cam * n_px:
        raise ValueError(f"{len(devices)} devices for a ({n_cam}, {n_px}) "
                         "mesh")
    return Mesh(tuple(tuple(devices[c * n_px:(c + 1) * n_px])
                      for c in range(n_cam)))


def replicate_world(world, meta: WorldMeta, mesh: Mesh) -> dict:
    """The world on every distinct device of the mesh, {device:
    TorchWorld}, shared by repeated devices (jax.device_put(world, P())).
    world: the numpy WorldDev (world_to_torch builds each device's
    tables), a TorchWorld whose device is the mesh's only one, or a dict
    this function returned."""
    devs = set(mesh.flat)
    if isinstance(world, dict):
        out = world
    elif isinstance(world, TorchWorld):
        out = {world.device: world}
    else:
        return {d: world_to_torch(world, meta, d) for d in devs}
    if not devs <= set(out):
        raise ValueError(f"the world lies on {sorted(map(str, out))}, not "
                         f"on every mesh device {sorted(map(str, devs))}: "
                         "pass the numpy world")
    return out


def _pad_flat(a: torch.Tensor, n_to: int, fill) -> torch.Tensor:
    """a padded along its last dimension to n_to with fill
    (sharding.py:82)."""
    return torch.nn.functional.pad(a, (0, n_to - a.shape[-1]), value=fill)


def _cam_vectors(cfg: RenderConfig, cams: torch.Tensor):
    """(rayb, rdx, rdy) [C, 3] of each camera (camera_vectors over the
    batch, in sharding.py:117-125's association)."""
    h, w = cfg.height, cfg.width
    xrat = F32(-1.0)
    yrat = -(F32(h) / F32(w))
    xsrat = float(F32(2.0) * xrat / F32(w))
    ysrat = float(F32(2.0) * yrat / F32(h))
    rayb = cams[:, 2, :3] + (float(-xrat) * cams[:, 0, :3]
                             + float(-yrat) * cams[:, 1, :3])
    return rayb, xsrat * cams[:, 0, :3], ysrat * cams[:, 1, :3]


def _columns(w: int, dev) -> torch.Tensor:
    """x + 1 of each pixel column as f32, the rays' column factor."""
    return torch.arange(1, w + 1, dtype=torch.int32, device=dev).to(
        torch.float32)


def camera_rays(cfg: RenderConfig, cams: torch.Tensor, seeds: torch.Tensor):
    """(origins, rays, seeds) of every pixel of C cameras, flat [C*h*w]
    camera-major and row-major within a camera (sharding.py:114-132,
    171-176).  cams: [C, 4, 4] f32 tensor (rows: basis x, y, z, then the
    position); seeds: the [h*w] int32 seed image every camera shares."""
    h, w = cfg.height, cfg.width
    c = cams.shape[0]
    dev = cams.device
    rayb, rdx, rdy = _cam_vectors(cfg, cams)
    ys = torch.arange(h, dtype=torch.int32, device=dev).to(torch.float32)
    xs = _columns(w, dev)

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


# ---- the mesh: layouts, halo exchange, band blur ----------------------------

def _shard_index(mesh: Mesh, k: int, axes: tuple) -> int:
    """Index of mesh position k along `axes` taken in order, as
    sharding.py:271-273 folds jax.lax.axis_index."""
    pos = {"cam": k // mesh.shape["px"], "px": k % mesh.shape["px"]}
    idx = 0
    for a in axes:
        idx = idx * mesh.shape[a] + pos[a]
    return idx


def _split(x: torch.Tensor, mesh: Mesh, cam_axes: tuple, row_axes: tuple,
           hb: int) -> list:
    """[C, hb * nrow, w] -> each mesh position's [C / ncam, hb, w] part
    (its cameras' rows of its row band) on its device."""
    ncam = prod(mesh.shape[a] for a in cam_axes)
    cl = x.shape[0] // ncam
    parts = []
    for k, dev in enumerate(mesh.flat):
        ci, ri = (_shard_index(mesh, k, cam_axes),
                  _shard_index(mesh, k, row_axes))
        parts.append(x[ci * cl:(ci + 1) * cl, ri * hb:(ri + 1) * hb]
                     .to(dev).contiguous())
    return parts


def _gather(parts: list, mesh: Mesh, cam_axes: tuple,
            row_axes: tuple) -> torch.Tensor:
    """Inverse of _split: the [C, hb * nrow, w] whole on mesh.flat[0]."""
    dev0 = mesh.flat[0]
    at = {(_shard_index(mesh, k, cam_axes), _shard_index(mesh, k, row_axes)):
          p for k, p in enumerate(parts)}
    ncam = prod(mesh.shape[a] for a in cam_axes)
    nrow = prod(mesh.shape[a] for a in row_axes)
    return torch.cat([torch.cat([at[(ci, ri)].to(dev0) for ri in range(nrow)],
                                dim=1) for ci in range(ncam)])


def _halo(hb: int, nrow: int) -> tuple[int, int]:
    """(K, H): K band hops cover >= RR rows (or the whole frame), the
    halo is H = min(RR, K * hb) rows (sharding.py:240-242)."""
    K = 0 if nrow == 1 else min(-(-RR // hb), nrow - 1)
    return K, min(RR, K * hb)


def _exchange(parts: list, mesh: Mesh, cam_axes: tuple, row_axes: tuple,
              hb: int) -> list:
    """Each part's [cl, hb+2H, w] band with H halo rows from the row
    neighbours of its cameras (sharding.py:253-267's ppermutes), zero
    past the frame edges.  Copies from a neighbour count into
    EXCHANGE_BYTES."""
    global EXCHANGE_BYTES
    nrow = prod(mesh.shape[a] for a in row_axes)
    K, H = _halo(hb, nrow)
    if K == 0:
        return parts
    at = {(_shard_index(mesh, k, cam_axes), _shard_index(mesh, k, row_axes)):
          p for k, p in enumerate(parts)}
    # the halo band is rows [K*hb - H, K*hb + hb + H) of the stack of the
    # 2K+1 bands ri-K .. ri+K
    s, e = K * hb - H, K * hb + hb + H
    out = []
    for k, dev in enumerate(mesh.flat):
        ci, ri = (_shard_index(mesh, k, cam_axes),
                  _shard_index(mesh, k, row_axes))
        own = parts[k]
        pieces = []
        for j in range(2 * K + 1):
            lo, hi = max(s - j * hb, 0), min(e - j * hb, hb)
            if lo >= hi:
                continue
            rj = ri + j - K
            if j == K:
                pieces.append(own[:, lo:hi])
            elif 0 <= rj < nrow:
                src = at[(ci, rj)][:, lo:hi]
                EXCHANGE_BYTES += src.numel() * src.element_size()
                pieces.append(src.to(dev))
            else:
                pieces.append(own.new_zeros((own.shape[0], hi - lo,
                                             own.shape[2])))
        out.append(torch.cat(pieces, dim=1))
    return out


def _reach(zparts: list, fstr: float, dev0) -> float:
    """max |zbuf - 1| * fstr over every part (sharding.py:249), f32, read
    to the host: the one host read of a mesh blur."""
    m = torch.stack([(z - 1.0).abs().amax().to(dev0) for z in zparts])
    return float(m.amax() * fstr)


def _dof_blur_mesh(fb, zbuf, cfg: RenderConfig, mesh: Mesh, cam_axes: tuple,
                   row_axes: tuple, band: int = 0, real_h: int = 0) -> list:
    """Row-band sharded DoF blur (sharding.py:199-323): each mesh
    position blurs the rows it owns after a halo exchange, one band
    kernel launch a pass.  Bit-identical to the per-camera dof_blur.

    cam_axes / row_axes: the mesh axes that split the cameras and the
    rows (row_axes may name both axes for a single-camera frame).  With
    band = 0, fb, zbuf are [C, h, w] tensors, padded here to hb * nrow
    rows (zbuf with 1.0) and split; with band, they are each mesh
    position's [cl, band, w] part (_split's layout, already padded with
    zbuf 1.0) and real_h is the camera's true frame height.  Returns
    the blurred fb's parts.

    The band blur runs only when the largest tap reach over every camera
    and row is under RR - 0.5 rows; else the passes run gathered on each
    camera group's first device (the frame kernel on the true rows, then
    re-padded and split), counted in FALLBACKS.  JAX takes this branch
    on the device (lax.cond); here it costs one host read a call."""
    global FALLBACKS
    passes = cfg.postproc_blur
    nrow = prod(mesh.shape[a] for a in row_axes)
    if band:
        fparts, zparts = list(fb), list(zbuf)
        hb, h = band, real_h
        if not h or len(fparts) != mesh.size or any(
                p.shape[1] != band for p in (*fparts, *zparts)):
            raise ValueError("band mode needs real_h and one [cl, band, w] "
                             "part of fb and zbuf per mesh position")
    else:
        h = fb.shape[1]
        hp2 = -(-h // (BR * nrow)) * (BR * nrow)
        hb = hp2 // nrow
        pad = (0, 0, 0, hp2 - h)
        fparts = _split(torch.nn.functional.pad(fb, pad), mesh, cam_axes,
                        row_axes, hb)
        zparts = _split(torch.nn.functional.pad(zbuf, pad, value=1.0), mesh,
                        cam_axes, row_axes, hb)
    if _reach(zparts, _fstr(h), mesh.flat[0]) < RR - 0.5:
        for _ in range(passes):
            padded = _exchange(fparts, mesh, cam_axes, row_axes, hb)
            fparts = [dof_blur_band(fp, zp,
                                    _shard_index(mesh, k, row_axes) * hb, h)
                      for k, (fp, zp) in enumerate(zip(padded, zparts))]
        return fparts
    FALLBACKS += passes
    out = [None] * mesh.size
    ncam = prod(mesh.shape[a] for a in cam_axes)
    for ci in range(ncam):
        ks = sorted((k for k in range(mesh.size)
                     if _shard_index(mesh, k, cam_axes) == ci),
                    key=lambda k: _shard_index(mesh, k, row_axes))
        dev = mesh.flat[ks[0]]
        f = torch.cat([fparts[k].to(dev) for k in ks], dim=1)
        z = torch.cat([zparts[k].to(dev) for k in ks], dim=1)
        f = torch.cat([dof_blur(f[:, :h].contiguous(), z[:, :h].contiguous(),
                                passes), f[:, h:]], dim=1)
        for ri, k in enumerate(ks):
            out[k] = f[:, ri * hb:(ri + 1) * hb].to(mesh.flat[k]).contiguous()
    return out


# ---- one camera's frame over the mesh ---------------------------------------

def _band_rows(cfg: RenderConfig, n_bands: int) -> int:
    """Rows a band of the banded mesh path, or 0 if the frame does not
    band (parity, mesh_bands off, or fewer 8-row groups than bands):
    sharding.py:530-549's layout-free branch, BH = 8.  The TPU's 64-row
    bands change no output bit."""
    if cfg.parity or not cfg.mesh_bands or n_bands < 1:
        return 0
    if cfg.height // BR < n_bands:
        return 0
    return -(-cfg.height // (BR * n_bands)) * BR


def _trace_band(tw: TorchWorld, cfg: RenderConfig, fv: V3, rv: V3, seeds,
                sec, hw):
    """One trace launch on a band's device -> (fb, zbuf) of shape hw
    (sharding.py:552-565)."""
    fb, zb = trace_wave(tw, cfg, fv, rv, seeds, sec, pack=True,
                        page0=cfg.cam_page)
    return fb.reshape(hw), zb.reshape(hw)


def _trace_split(tws: dict, cfg: RenderConfig, mesh: Mesh, cols: list,
                 sec):
    """The flat paths' trace: the padded flat batch `cols` (origin x, y,
    z, ray x, y, z, seeds) split into one contiguous slice a mesh
    position, traced there in one launch.  Returns (fb, zbuf) flat,
    gathered on mesh.flat[0]."""
    dev0 = mesh.flat[0]
    m = cols[0].shape[0] // mesh.size
    fbs, zbs = [], []
    for k, dev in enumerate(mesh.flat):
        a = [col[k * m:(k + 1) * m].to(dev) for col in cols]
        fb, zb = _trace_band(tws[dev], cfg, V3(*a[:3]), V3(*a[3:6]), a[6],
                             sec, (m,))
        fbs.append(fb.to(dev0))
        zbs.append(zb.to(dev0))
    return torch.cat(fbs), torch.cat(zbs)


def _render_frame_mesh_banded(tws: dict, cfg: RenderConfig, mesh: Mesh,
                              origin, rayb, rdx, rdy, sec):
    """ONE camera's frame as contiguous row bands, one per mesh position
    (sharding.py:569-649): each device generates its band's rays and
    seeds from the camera vectors, traces them (one launch) and, with
    cfg.postproc_blur, blurs them after the halo exchange.  Pad rows
    (>= h) get the dead-ray fills and seed 1, and zbuf 1.0 in the blur.
    Returns the (fb, zbuf) parts, [Rloc, w] each on its device."""
    h, w = cfg.height, cfg.width
    rloc = _band_rows(cfg, mesh.size)
    fbs, zbs, zb1 = [], [], []
    for k, dev in enumerate(mesh.flat):
        og, rb, rx, ry = (_vec3(v, dev) for v in (origin, rayb, rdx, rdy))
        ys = k * rloc + torch.arange(rloc, dtype=torch.int64, device=dev)
        live = (ys < h)[:, None]
        ysf = ys.to(torch.float32)          # the global row
        xs = _columns(w, dev)

        def comp(i, fill):
            v = (rb[i] + ysf[:, None] * ry[i]) + xs[None, :] * rx[i]
            return torch.where(live, v, fill).reshape(-1)

        rv = V3(comp(0, _FILLS["rx"]), comp(1, _FILLS["ry"]),
                comp(2, _FILLS["rz"]))
        xs_u = torch.arange(w, dtype=torch.int64, device=dev)
        seeds = torch.where(live, lcg.to_i32_bits(lcg.pixel_seed(
            xs_u[None, :], ys[:, None], w)), _FILLS["seed"]).reshape(-1)
        n = rloc * w
        fv = V3(*(og[i].expand(n) for i in range(3)))
        fb, zb = _trace_band(tws[dev], cfg, fv, rv, seeds, sec, (rloc, w))
        fbs.append(fb)
        zbs.append(zb)
        zb1.append(torch.where(live, zb, 1.0)[None])
    if cfg.postproc_blur:
        fbs = [p[0] for p in _dof_blur_mesh([f[None] for f in fbs], zb1, cfg,
                                            mesh, (), AXES, band=rloc,
                                            real_h=h)]
    return fbs, zbs


def _render_frame_mesh(tws: dict, cfg: RenderConfig, mesh: Mesh, origin,
                       rayb, rdx, rdy, sec):
    """The flat path (sharding.py:475-527) with (bh, bw) = (1, w): the
    row-major ray batch, padded with dead rays to a multiple of
    w * mesh.size, is split into one contiguous slice a device and
    traced there (one launch each); the gathered frame is blurred over
    the mesh in _dof_blur_mesh's own bands.  Returns (fb [h, w], zbuf
    [h, w]) on mesh.flat[0]."""
    h, w = cfg.height, cfg.width
    n = h * w
    dev0 = mesh.flat[0]
    rays = gen_rays(_vec3(rayb, dev0), _vec3(rdx, dev0), _vec3(rdy, dev0),
                    w, h)
    o = _vec3(origin, dev0)
    npad2 = -(-h // mesh.size) * mesh.size * w
    cols = [_pad_flat(a, npad2, fill) for a, fill in zip(
        (*(o[i].expand(n) for i in range(3)), *rays,
         pixel_seeds(w, h, dev0)), _FILLS.values())]
    fbs, zbs = _trace_split(tws, cfg, mesh, cols, sec)
    fb, zb = fbs[:n].reshape(h, w), zbs[:n].reshape(h, w)
    if cfg.postproc_blur:
        parts = _dof_blur_mesh(fb[None], zb[None], cfg, mesh, (), AXES)
        fb = _gather(parts, mesh, (), AXES)[0, :h]
    return fb, zb


def render_frame_sharded(world, meta: WorldMeta, cfg: RenderConfig, origin,
                         rayb, rdx, rdy, sec, mesh: Mesh):
    """One camera's frame over every device of the mesh
    (sharding.py:652-671), fast mode only: row-banded when the frame is
    tall enough (_band_rows), else the flat path.  world: see
    replicate_world.  Returns (fb [h, w] int32 BGRA bits, zbuf [h, w]
    f32) gathered on the mesh's first device, bit-equal to
    render.frame.render_frame."""
    if cfg.parity:
        raise ValueError(
            "render_frame_sharded is fast-mode only; parity-exact frames "
            "go through render.frame.render_frame")
    if not 0 <= cfg.cam_page < meta.n_pages:
        raise ValueError(f"cam_page {cfg.cam_page} is not a page of a "
                         f"{meta.n_pages}-page world")
    tws = replicate_world(world, meta, mesh)
    if _band_rows(cfg, mesh.size):
        fbs, zbs = _render_frame_mesh_banded(tws, cfg, mesh, origin, rayb,
                                             rdx, rdy, sec)
        h = cfg.height
        return (_gather([f[None] for f in fbs], mesh, (), AXES)[0, :h],
                _gather([z[None] for z in zbs], mesh, (), AXES)[0, :h])
    return _render_frame_mesh(tws, cfg, mesh, origin, rayb, rdx, rdy, sec)


# ---- the camera batch over the mesh -----------------------------------------

def _render_cams_mesh_banded(tws: dict, cfg: RenderConfig, mesh: Mesh,
                             cams: torch.Tensor, seeds: torch.Tensor, sec):
    """Cameras over "cam", each camera's rows over "px" as contiguous
    bands (sharding.py:357-416): each mesh position generates its
    cameras' band rays from their vectors, takes the caller's seed image
    (band rows only), traces them in one launch and blurs them after the
    halo exchange over px.  Returns the (fb, zbuf) parts, [C / n_cam,
    Rloc, w] each on its device."""
    h, w = cfg.height, cfg.width
    n_px = mesh.shape["px"]
    rloc = _band_rows(cfg, n_px)
    hp2 = rloc * n_px
    cl = cams.shape[0] // mesh.shape["cam"]
    vecs = _cam_vectors(cfg, cams)
    seeds_p = torch.nn.functional.pad(seeds.reshape(h, w), (0, 0, 0, hp2 - h),
                                      value=_FILLS["seed"])
    fbs, zbs, zb1 = [], [], []
    for k, dev in enumerate(mesh.flat):
        ci, pi = k // n_px, k % n_px
        cs = slice(ci * cl, (ci + 1) * cl)
        og = cams[cs, 3, :3].to(dev)
        rb, rx, ry = (v[cs].to(dev) for v in vecs)
        ys = pi * rloc + torch.arange(rloc, dtype=torch.int64, device=dev)
        live = (ys < h)[None, :, None]
        ysf = ys.to(torch.float32)
        xs = _columns(w, dev)

        def comp(i, fill):
            v = ((rb[:, i, None, None] + ysf[None, :, None]
                  * ry[:, i, None, None])
                 + xs[None, None, :] * rx[:, i, None, None])
            return torch.where(live, v, fill).reshape(-1)

        rv = V3(comp(0, _FILLS["rx"]), comp(1, _FILLS["ry"]),
                comp(2, _FILLS["rz"]))
        sd = seeds_p[pi * rloc:(pi + 1) * rloc].to(dev)
        s = sd[None].expand(cl, rloc, w).reshape(-1)
        fv = V3(*(og[:, i].repeat_interleave(rloc * w) for i in range(3)))
        fb, zb = _trace_band(tws[dev], cfg, fv, rv, s, sec, (cl, rloc, w))
        fbs.append(fb)
        zbs.append(zb)
        zb1.append(torch.where(live, zb, 1.0))
    if cfg.postproc_blur:
        fbs = _dof_blur_mesh(fbs, zb1, cfg, mesh, ("cam",), ("px",),
                             band=rloc, real_h=h)
    return fbs, zbs


def _render_cams_mesh(tws: dict, cfg: RenderConfig, mesh: Mesh,
                      cams: torch.Tensor, seeds: torch.Tensor, sec):
    """The camera batch over the mesh (sharding.py:327-472): banded when
    each camera's rows band over px, else the flat path with (bh, bw) =
    (1, w), whose row-major batch (each camera padded to a multiple of
    w * n_px rays) is split into one slice a mesh position, traced
    there, gathered and blurred over the mesh.  cams: [C, 4, 4] and
    seeds [h*w] on mesh.flat[0].  Returns (fb, zbuf) [C, h, w] there."""
    h, w = cfg.height, cfg.width
    if _band_rows(cfg, mesh.shape["px"]):
        fbs, zbs = _render_cams_mesh_banded(tws, cfg, mesh, cams, seeds, sec)
        return (_gather(fbs, mesh, ("cam",), ("px",))[:, :h],
                _gather(zbs, mesh, ("cam",), ("px",))[:, :h])
    c = cams.shape[0]
    n = h * w
    n_px = mesh.shape["px"]
    npad2 = -(-h // n_px) * n_px * w
    origins, rays, seeds_flat = camera_rays(cfg, cams, seeds)

    cols = [_pad_flat(a.reshape(c, n), npad2, fill).reshape(-1)
            for a, fill in zip((*origins, *rays, seeds_flat),
                               _FILLS.values())]
    fbs, zbs = _trace_split(tws, cfg, mesh, cols, sec)
    fb = fbs.reshape(c, npad2)[:, :n].reshape(c, h, w)
    zb = zbs.reshape(c, npad2)[:, :n].reshape(c, h, w)
    if cfg.postproc_blur:
        parts = _dof_blur_mesh(fb, zb, cfg, mesh, ("cam",), ("px",))
        fb = _gather(parts, mesh, ("cam",), ("px",))[:, :h]
    return fb, zb


def render_cameras(world, meta: WorldMeta, cfg: RenderConfig,
                   cams: np.ndarray, sec, mesh: Mesh | None = None
                   ) -> torch.Tensor:
    """Batched multi-camera render (sharding.py:674-708).  cams: [C, 4,
    4] float32 camera matrices, as the JAX package takes them.  Returns
    the [C, h, w] int32 framebuffer (uint32 BGRA bits).  Honours
    cfg.postproc_blur (per-camera DoF).

    mesh None: world is a TorchWorld, and the batch renders on its
    device.  A mesh of one device renders the same way there; a larger
    one shards cameras over "cam" (C % n_cam == 0) and each camera's
    rows over "px", world as replicate_world takes it, and returns the
    frames gathered on the mesh's first device.  Parity mode is
    rejected, as in the JAX package: its serial ray-offset accumulation
    exists only on the single-camera path (render.frame.gen_rays)."""
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
    if mesh is not None:
        if cams.shape[0] % mesh.shape["cam"]:
            raise ValueError(f"{cams.shape[0]} cameras do not split over "
                             f"{mesh.shape['cam']} camera shards")
        tws = replicate_world(world, meta, mesh)
        world = tws[mesh.flat[0]]
    dev = world.device
    seeds = pixel_seeds(cfg.width, cfg.height, dev)
    cams_d = torch.from_numpy(cams).to(dev)
    if mesh is not None and mesh.size > 1:
        fb, _ = _render_cams_mesh(tws, cfg, mesh, cams_d, seeds, F32(sec))
    else:
        fb, _ = _render_cams(world, cfg, cams_d, seeds, F32(sec))
    return fb
