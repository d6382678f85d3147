"""The CUDA kernels of the port against their plain torch versions, on
the card.  Skipped where torch sees no CUDA device.

The repository's tests/conftest.py imports jax, which the card's machine
need not have, so run these there with:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Small versions of chip_smoke.py's phases 3-10: the blur kernel equals
the plain pass bit for bit, on one frame and on stacked camera frames
(where it also equals one launch per frame); the tracer kernel equals
the plain tracer bit for bit in fb and zbuf (the same device math
functions, no FMA contraction on either side), in fast mode on one page,
on the paged maze, with samples > 1 and over a camera batch, and in
parity mode, where it also equals the plain parity tracer run on the
host's CPU; render_frame, render_accumulated and render_cameras launch
each kernel once per frame or step.  The band blur kernel equals its
plain version and the frame kernel's rows on every band, and on a
virtual mesh of the card repeated 8 times render_frame_sharded equals
render_frame and render_cameras with a mesh equals it without (phase
11's checks, small).  Phases 12-14, small: the parity samples instance
equals the plain parity tracer and render_accumulated(parity) launches it
once; the fast tracer equals the plain one on the portal chain (config
#2); the probe kernels add_one and vpu_chains equal their plain
versions.  Phases 15-16, small: the fused instance equals the plain
fused loop (flagship, portal chain, paged maze, 64 spheres) and its zbuf
the unfused kernel's; the parity instances on the paged maze equal the plain parity
tracer on the card (and on the host), and the parity frame of the chain
on three pages equals the one-page chain's, kernel against kernel.
Each warp of the tracer takes an 8x4-pixel tile: every rendering
instance equals the plain tracer at ragged shapes (and where the width
does not divide n, in the flat order), as do two launches in a row and
launches on two streams at once; the fast instances keep no unwind
record on the stack and spill nothing.  The launch route (`_launch`):
add_one, dof_blur and trace_wave (one-chain and samples instances) on
a side stream and replayed from a CUDA graph equal plain, and an entry
that refuses its arguments raises.  The samples instances, which shade
the primary segment once for all chains, equal plain at ragged shapes,
samples 2, 3 and 5 and reflect 0, 1 and 6, on the paged maze and on two
streams at once; the one-chain instances compile to the registers and
spills they had before, and the blur's four instances the registers
recorded for them with no spill.  The blur kernel also equals its plain
version on depths that mix tiles it stages a tap window for with tiles
over the window's cap (NaN, +-inf, +-1e30; 1080p, 720p, ragged, stacked,
unaligned, more row tiles than the grid holds) and, in its band form, on
the flagship's 8 bands and on bands whose taps fall past a 2-row halo.
Phase 20, small: a world of 64 spheres, the
object pool's capacity, through each rendering instance equals plain.
The parity instance equals plain on seeded random rays through the
fuzz level (rotated portals, ramps, fog, 2-high cells) at reflect 2 and
6, and its phases instance gives its bits while counting every region.
Slice 14 (chip_smoke phases 21-24, small): every rendering instance
with the colour unpacked equals the plain C4 and packs to its own fb;
the measurement knobs in parity mode (one instance a knob), with
samples 2 and the fused loop and several at once (the instances that
read their knobs at run time) equal plain; the new instances compile to
the registers and spills recorded for them; shard_trace's parts equal
trace_wave; the generated cave level's frame equals plain in both
modes.  The frame's rays (csrc/rays.cu through frame_rays, one launch)
equal the plain path's bits in both modes at 1080p, 320x240, 203x150
and 1x1, and a frame in either mode, with one sample or four, calls no
stream synchronisation.  Frames run on the render stream: 12 frames
copied in the benchmark harness's loop through 2 pinned buffers, the
caller's stream held back, each equal the plain rays' frame; a world
tensor written in place shows in the next frame; one world joins the
caller's stream once, a game session on every tick."""

import dataclasses
import re

import numpy as np
import pytest
import torch

from pwnfps_tpu_torch import _build
from pwnfps_tpu_torch.ops import blur, probes, tracer
from pwnfps_tpu_torch.ops.vec import V3
from pwnfps_tpu_torch.parallel.sharding import (_halo, camera_rays,
                                                render_cameras,
                                                render_frame_sharded,
                                                shard_trace)
from pwnfps_tpu_torch.render import frame as frame_mod
from pwnfps_tpu_torch.render.frame import (frame_rays, gen_rays, pixel_seeds,
                                           render_accumulated, render_frame)
from pwnfps_tpu_torch.ops.tracer_core import col_ftoint
from pwnfps_tpu_torch.scene import (cave_scene, flagship_scene, fuzz_rays,
                                    maze_scene,
                                    mesh_for, multicam_scene, parity_scene,
                                    portal_camera, ptrace_scene,
                                    ring_scene, spheres_scene, stress_scene)
from pwnfps_tpu_torch.tools import host_blur, ieee_check
from pwnfps_tpu_torch.tools.vpu_probe import plane

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda", 0)


def _frame_inputs(sc, k, dev):
    origin, rayb, rdx, rdy, sec = sc.frame_args(k)
    c = sc.cfg
    rays = gen_rays(torch.from_numpy(rayb).to(dev),
                    torch.from_numpy(rdx).to(dev),
                    torch.from_numpy(rdy).to(dev), c.width, c.height,
                    c.parity)
    n = c.width * c.height
    ifrom = V3(*(torch.full((n,), float(origin[i]), device=dev)
                 for i in range(3)))
    return ifrom, rays, pixel_seeds(c.width, c.height, dev), sec


@pytest.mark.parametrize("h,w,passes", [(37, 100, 1), (48, 64, 2),
                                        (180, 320, 1)])
def test_blur_kernel_equals_plain(dev, h, w, passes):
    rng = np.random.default_rng(h + w)
    fb = rng.integers(0, 2 ** 32, (h, w), dtype=np.uint64).astype(np.uint32)
    z = rng.uniform(-0.5, 40.0, (h, w)).astype(np.float32)
    for val in (1e30, -1e30, np.nan):
        z[rng.random((h, w)) < 0.02] = val
    fb_t = torch.from_numpy(fb.view(np.int32)).to(dev)
    z_t = torch.from_numpy(z).to(dev)
    before = blur.LAUNCHES
    got = blur.dof_blur(fb_t, z_t, passes)
    assert blur.LAUNCHES == before + passes
    want = blur.dof_blur_plain(fb_t, z_t, passes)
    assert torch.equal(got, want)


# (h, w, frames, how): depths that mix tiles the kernel stages a window
# for with tiles over its cap, NaN, +-inf and +-1e30 (host_blur.
# reach_frame); "unaligned": fb one word past a 16-byte boundary, so the
# window takes 4-byte copies although w % 4 == 0
@pytest.mark.parametrize("h,w,nf,how", [(1080, 1920, 1, ""),
                                        (720, 1280, 1, ""),
                                        (150, 203, 1, ""),
                                        (120, 160, 64, ""),
                                        (200, 131, 3, ""),
                                        (136, 256, 2, "unaligned")])
def test_blur_kernel_reach_mixes(dev, h, w, nf, how):
    fb, z = host_blur.reach_frame(h, w, h * w + nf, nf)
    fb, z = fb.to(dev), z.to(dev)
    if how == "unaligned":
        buf = torch.empty(fb.numel() + 1, dtype=torch.int32, device=dev)
        buf[1:] = fb.view(-1)
        fb = buf[1:].view(fb.shape)
        assert fb.data_ptr() % 16 == 4
    before = (blur.LAUNCHES, blur.LAUNCHES_FRAMES)
    got = blur.dof_blur(fb, z, 1, frame_h=h)
    assert (blur.LAUNCHES, blur.LAUNCHES_FRAMES) == (before[0] + 1,
                                                     before[1] + (nf > 1))
    assert torch.equal(got, blur.dof_blur_plain(fb, z, 1, frame_h=h))


def test_blur_kernel_tiles_past_the_grid(dev):
    """65,600 stacked 16-row frames 7 wide: more row tiles than the
    grid's 65,535, so blocks take a second tile by the stride loop."""
    h, w, nf = 16, 7, 65600
    fb, z = host_blur.reach_frame(h, w, 5, nf, extremes=False)
    fb, z = fb.to(dev), z.to(dev)
    got = blur.dof_blur(fb, z, 1, frame_h=h)
    assert torch.equal(got, blur.dof_blur_plain(fb, z, 1, frame_h=h))


@pytest.mark.parametrize("frame", [1, 4])
def test_tracer_kernel_matches_plain(dev, frame):
    sc = flagship_scene(96, 64, dev)
    ifrom, rays, seeds, sec = _frame_inputs(sc, frame, dev)
    before = tracer.LAUNCHES
    fb_k, z_k = tracer.trace_wave(sc.tworld, sc.cfg, ifrom, rays, seeds,
                                  sec, pack=True)
    assert tracer.LAUNCHES == before + 1
    fb_p, z_p = tracer.trace_wave_plain(sc.tworld, sc.cfg, ifrom, rays,
                                        seeds, sec, pack=True)
    fb_bit = (fb_k == fb_p).float().mean().item()
    z_bit = (z_k.view(torch.int32) == z_p.view(torch.int32)).float().mean()
    msg = f"fb {fb_bit:.4f} bit-exact, zbuf {z_bit.item():.4f} bit-exact"
    assert torch.equal(fb_k, fb_p), msg
    assert torch.equal(z_k.view(torch.int32), z_p.view(torch.int32)), msg


@pytest.mark.parametrize("frame", [0, 3])
def test_parity_kernel_matches_plain(dev, frame):
    sc = parity_scene(96, 64, dev)
    ifrom, rays, seeds, sec = _frame_inputs(sc, frame, dev)
    before = (tracer.LAUNCHES, tracer.LAUNCHES_PARITY)
    fb_k, z_k = tracer.trace_wave(sc.tworld, sc.cfg, ifrom, rays, seeds,
                                  sec, pack=True)
    assert (tracer.LAUNCHES, tracer.LAUNCHES_PARITY) == \
        (before[0], before[1] + 1)
    fb_p, z_p = tracer.trace_wave_plain(sc.tworld, sc.cfg, ifrom, rays,
                                        seeds, sec, pack=True)
    assert torch.equal(fb_k, fb_p)
    assert torch.equal(z_k.view(torch.int32), z_p.view(torch.int32))


def test_parity_kernel_matches_host_plain(dev):
    host = parity_scene(32, 24, "cpu")
    card = parity_scene(32, 24, dev)
    fb_h, z_h = tracer.trace_wave(host.tworld, host.cfg,
                                  *_frame_inputs(host, 0, "cpu"), pack=True)
    fb_k, z_k = tracer.trace_wave(card.tworld, card.cfg,
                                  *_frame_inputs(card, 0, dev), pack=True)
    assert torch.equal(fb_k.cpu(), fb_h)
    assert torch.equal(z_k.cpu().view(torch.int32), z_h.view(torch.int32))


def test_parity_render_frame_launches_parity_kernel_once(dev):
    sc = parity_scene(64, 48, dev)
    before = (tracer.LAUNCHES, tracer.LAUNCHES_PARITY, blur.LAUNCHES)
    fb, zb = render_frame(sc.tworld, sc.meta, sc.cfg, *sc.frame_args(1))
    torch.cuda.synchronize()
    assert (tracer.LAUNCHES - before[0], tracer.LAUNCHES_PARITY - before[1],
            blur.LAUNCHES - before[2]) == (0, 1, 1)
    assert fb.shape == (48, 64) and not bool(torch.isnan(zb).any())
    assert torch.unique(fb).numel() > 100


def test_render_frame_launches_each_kernel_once(dev):
    sc = flagship_scene(128, 72, dev)
    before = (tracer.LAUNCHES, blur.LAUNCHES)
    fb, zb = render_frame(sc.tworld, sc.meta, sc.cfg, *sc.frame_args(2))
    torch.cuda.synchronize()
    assert (tracer.LAUNCHES - before[0], blur.LAUNCHES - before[1]) == (1, 1)
    assert fb.shape == (72, 128) and fb.dtype == torch.int32
    assert fb.device.type == "cuda" and torch.isfinite(zb).all()
    assert torch.unique(fb).numel() > 100


@pytest.mark.parametrize("view", ["portal", "path"])
def test_paged_kernel_matches_plain(dev, view):
    """160x90 maze frames: from a camera facing a cross-page portal (most
    primary rays change page) and from the camera path's frame 3."""
    sc = maze_scene(160, 90, dev)
    if view == "portal":
        sc.cam = portal_camera(sc)
    ifrom, rays, seeds, sec = _frame_inputs(sc, 0 if view == "portal" else 3,
                                            dev)
    page0 = sc.cfg.cam_page
    before = (tracer.LAUNCHES, tracer.LAUNCHES_PAGED)
    fb_k, z_k = tracer.trace_wave(sc.tworld, sc.cfg, ifrom, rays, seeds,
                                  sec, pack=True, page0=page0)
    assert (tracer.LAUNCHES, tracer.LAUNCHES_PAGED) == \
        (before[0], before[1] + 1)
    fb_p, z_p = tracer.trace_wave_plain(sc.tworld, sc.cfg, ifrom, rays,
                                        seeds, sec, pack=True, page0=page0)
    assert torch.equal(fb_k, fb_p)
    assert torch.equal(z_k.view(torch.int32), z_p.view(torch.int32))


def test_maze_render_frame_launches_paged_kernel_once(dev):
    sc = maze_scene(128, 72, dev)
    before = (tracer.LAUNCHES, tracer.LAUNCHES_PAGED, blur.LAUNCHES)
    fb, zb = render_frame(sc.tworld, sc.meta, sc.cfg, *sc.frame_args(2))
    torch.cuda.synchronize()
    assert (tracer.LAUNCHES - before[0], tracer.LAUNCHES_PAGED - before[1],
            blur.LAUNCHES - before[2]) == (0, 1, 1)
    assert fb.shape == (72, 128) and torch.isfinite(zb).all()
    assert torch.unique(fb).numel() > 100


def _counts():
    return (tracer.LAUNCHES, tracer.LAUNCHES_PAGED, tracer.LAUNCHES_SAMPLES,
            tracer.LAUNCHES_PARITY, tracer.LAUNCHES_PARITY_SAMPLES,
            blur.LAUNCHES, blur.LAUNCHES_FRAMES, tracer.LAUNCHES_FUSED,
            tracer.LAUNCHES_PARITY_PAGED)


def _delta(before):
    return tuple(a - b for a, b in zip(_counts(), before))


@pytest.mark.parametrize("world", ["ptrace", "maze"])
def test_samples_kernel_matches_plain(dev, world):
    """96x54 frames with samples > 1: config #5's scene (samples=4,
    reflect=6) and the maze from a portal-facing camera (samples=2)."""
    if world == "ptrace":
        sc = ptrace_scene(96, 54, dev)
    else:
        sc = maze_scene(96, 54, dev, samples=2)
        sc.cam = portal_camera(sc)
    ifrom, rays, seeds, sec = _frame_inputs(sc, 1, dev)
    page0 = sc.cfg.cam_page
    before = _counts()
    fb_k, z_k = tracer.trace_wave(sc.tworld, sc.cfg, ifrom, rays, seeds,
                                  sec, pack=True, page0=page0)
    assert _delta(before) == (0, 0, 1, 0, 0, 0, 0, 0, 0)
    fb_p, z_p = tracer.trace_wave_plain(sc.tworld, sc.cfg, ifrom, rays,
                                        seeds, sec, pack=True, page0=page0)
    assert torch.equal(fb_k, fb_p)
    assert torch.equal(z_k.view(torch.int32), z_p.view(torch.int32))


def test_render_accumulated_launches_samples_kernel_once(dev):
    sc = ptrace_scene(128, 72, dev)
    before = _counts()
    fb, zb = render_accumulated(sc.tworld, sc.meta, sc.cfg,
                                *sc.frame_args(2), samples=sc.cfg.samples)
    torch.cuda.synchronize()
    assert _delta(before) == (0, 0, 1, 0, 0, 1, 0, 0, 0)
    assert fb.shape == (72, 128) and torch.isfinite(zb).all()
    assert torch.unique(fb).numel() > 100


def test_camera_batch_kernels_match_plain(dev):
    """8 cameras at 32x24: the batch's trace against the plain tracer,
    the per-camera blur against its plain version and against one
    launch per frame."""
    sc = multicam_scene(dev, n_cams=8, width=32, height=24)
    cams, sec = sc.step_args(1)
    ifrom, rays, seeds = camera_rays(sc.cfg, torch.from_numpy(cams).to(dev),
                                     pixel_seeds(32, 24, dev))
    fb_k, z_k = tracer.trace_wave(sc.tworld, sc.cfg, ifrom, rays, seeds, sec,
                                  pack=True)
    fb_p, z_p = tracer.trace_wave_plain(sc.tworld, sc.cfg, ifrom, rays,
                                        seeds, sec, pack=True)
    assert torch.equal(fb_k, fb_p)
    assert torch.equal(z_k.view(torch.int32), z_p.view(torch.int32))
    fbs, zs = fb_k.reshape(8 * 24, 32), z_k.reshape(8 * 24, 32)
    before = _counts()
    got = blur.dof_blur(fbs, zs, 2, frame_h=24)
    assert _delta(before) == (0, 0, 0, 0, 0, 2, 2, 0, 0)
    assert torch.equal(got, blur.dof_blur_plain(fbs, zs, 2, frame_h=24))
    single = torch.cat([blur.dof_blur(fbs[c * 24:(c + 1) * 24],
                                      zs[c * 24:(c + 1) * 24], 2)
                        for c in range(8)])
    assert torch.equal(got, single)


@pytest.mark.parametrize("passes", [0, 1])
def test_render_cameras_launches_once(dev, passes):
    sc = multicam_scene(dev, n_cams=8, width=32, height=24,
                        postproc_blur=passes)
    before = _counts()
    fb = render_cameras(sc.tworld, sc.meta, sc.cfg, *sc.step_args(2))
    torch.cuda.synchronize()
    assert _delta(before) == (1, 0, 0, 0, 0, passes, passes, 0, 0)
    assert fb.shape == (8, 24, 32) and fb.device.type == "cuda"
    assert all(torch.unique(fb[c]).numel() > 20 for c in range(8))


def test_kernel_wrappers_reject_bad_inputs(dev):
    fb = torch.zeros((8, 16), dtype=torch.int32, device=dev)
    z = torch.zeros((16, 8), device=dev).t()          # not contiguous
    with pytest.raises(ValueError):
        blur.dof_blur(fb, z)
    with pytest.raises(ValueError):
        blur.dof_blur(fb, torch.zeros((8, 16)))       # CPU zbuf
    sc = flagship_scene(8, 4, dev)
    cpu = V3(*(torch.ones(4) for _ in range(3)))
    seeds = torch.zeros(4, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        tracer.trace_wave(sc.tworld, sc.cfg, cpu, cpu, seeds, 0.0)
    rays = V3(*(torch.ones(4, device=dev) for _ in range(3)))
    with pytest.raises(ValueError):                   # int64 seeds
        tracer.trace_wave(sc.tworld, sc.cfg, rays, rays, seeds.long(), 0.0,
                          pack=True)
    col, dist = tracer.trace_wave(sc.tworld, sc.cfg, rays, rays, seeds,
                                  0.0)                # the colour unpacked
    assert len(col) == 4 and all(c.shape == (4,) and c.is_cuda for c in col)


# (h, w, cl, rows a band, halo): the flagship's 8 bands of 136 rows and
# the mesh's 48-row halo, a w % 4 == 3 frame in 8-row bands, and bands
# with a 2-row halo whose taps fall one row past the buffer
@pytest.mark.parametrize("h,w,cl,hb,halo", [(1080, 1920, 2, 136, 48),
                                            (200, 203, 3, 8, 48),
                                            (75, 132, 2, 24, 2)])
def test_band_blur_kernel_reach_mixes(dev, h, w, cl, hb, halo):
    fb, z = host_blur.reach_frame(h, w, h + w + cl, cl)
    fb, z = fb.view(cl, h, w).to(dev), z.view(cl, h, w).to(dev)
    for fp, zb, y0 in host_blur.band_inputs(fb, z, hb, halo, -(-h // hb)):
        before = (blur.LAUNCHES, blur.LAUNCHES_BAND)
        got = blur.dof_blur_band(fp, zb, y0, h)
        assert (blur.LAUNCHES, blur.LAUNCHES_BAND) == (before[0],
                                                       before[1] + 1)
        assert torch.equal(got, blur.dof_blur_band_plain(fp, zb, y0, h)), y0


@pytest.mark.parametrize("h,w,hb,cl", [(64, 130, 16, 2), (200, 203, 32, 3)])
def test_band_blur_kernel_equals_plain(dev, h, w, hb, cl):
    """The band kernel on every band of cl padded frames, pad rows past
    the frame included, reach just under 47.5 rows: equal to its plain
    version, and its real rows to the frame kernel's."""
    nrow = -(-h // hb)
    _, H = _halo(hb, nrow)
    rng = np.random.default_rng(h * w)
    fb = rng.integers(0, 2 ** 32, (cl, h, w), dtype=np.uint64)
    fb = torch.from_numpy(fb.astype(np.uint32).view(np.int32)).to(dev)
    zmax = 1.0 + 47.4 / (0.002 * h)
    z = torch.from_numpy(rng.uniform(1.0, zmax, (cl, h, w)).astype(
        np.float32)).to(dev)
    full = blur.dof_blur(fb, z)
    hp2 = hb * nrow
    fbp = torch.nn.functional.pad(fb, (0, 0, H, hp2 - h + H))
    zp = torch.nn.functional.pad(z, (0, 0, 0, hp2 - h), value=1.0)
    for y0 in range(0, hp2, hb):
        fp = fbp[:, y0:y0 + hb + 2 * H].contiguous()
        zb = zp[:, y0:y0 + hb].contiguous()
        before = (blur.LAUNCHES, blur.LAUNCHES_BAND)
        got = blur.dof_blur_band(fp, zb, y0, h)
        assert (blur.LAUNCHES, blur.LAUNCHES_BAND) == (before[0],
                                                       before[1] + 1)
        assert torch.equal(got, blur.dof_blur_band_plain(fp, zb, y0, h))
        live = min(hb, h - y0)
        assert torch.equal(got[:, :live], full[:, y0:y0 + live])


@pytest.mark.parametrize("h", [64, 40])
def test_sharded_frame_equals_render_frame(dev, h):
    """96x64 bands (8 rows a device), 96x40 takes the flat path: 8 trace
    and 8 band blur launches a frame either way, no frame blur; the flat
    path's rays are one ray kernel launch, the bands build their own."""
    sc = flagship_scene(96, h, dev)
    args = sc.frame_args(2)
    before = (_counts(), blur.LAUNCHES_BAND, frame_mod.LAUNCHES_RAYS)
    fb, zb = render_frame_sharded(sc.tworld, sc.meta, sc.cfg, *args,
                                  mesh_for(2, 4, dev))
    torch.cuda.synchronize()
    assert (_delta(before[0]), blur.LAUNCHES_BAND - before[1],
            frame_mod.LAUNCHES_RAYS - before[2]) == (
        (8, 0, 0, 0, 0, 0, 0, 0, 0), 8, int(h == 40))
    fb1, zb1 = render_frame(sc.tworld, sc.meta, sc.cfg, *args)
    assert torch.equal(fb, fb1)
    assert torch.equal(zb.view(torch.int32), zb1.view(torch.int32))


def test_meshed_cameras_equal_one_device(dev):
    sc = multicam_scene(dev, n_cams=8, width=32, height=32, postproc_blur=1)
    before = (_counts(), blur.LAUNCHES_BAND)
    fb = render_cameras(sc.tworld, sc.meta, sc.cfg, *sc.step_args(2),
                        mesh_for(2, 4, dev))
    torch.cuda.synchronize()
    assert (_delta(before[0]), blur.LAUNCHES_BAND - before[1]) == (
        (8, 0, 0, 0, 0, 0, 0, 0, 0), 8)
    assert torch.equal(fb, render_cameras(sc.tworld, sc.meta, sc.cfg,
                                          *sc.step_args(2)))


@pytest.mark.parametrize("scene,samples", [("parity", 2), ("ptrace", 4)])
def test_parity_samples_kernel_matches_plain(dev, scene, samples):
    """64x48: the parity scene at samples 2 (reflect 2) and config #5's
    scene in parity mode (samples 4, reflect 6)."""
    sc = (parity_scene(64, 48, dev, samples=samples) if scene == "parity"
          else ptrace_scene(64, 48, dev, parity=True))
    ifrom, rays, seeds, sec = _frame_inputs(sc, 1, dev)
    before = _counts()
    fb_k, z_k = tracer.trace_wave(sc.tworld, sc.cfg, ifrom, rays, seeds,
                                  sec, pack=True)
    assert _delta(before) == (0, 0, 0, 0, 1, 0, 0, 0, 0)
    fb_p, z_p = tracer.trace_wave_plain(sc.tworld, sc.cfg, ifrom, rays,
                                        seeds, sec, pack=True)
    assert torch.equal(fb_k, fb_p)
    assert torch.equal(z_k.view(torch.int32), z_p.view(torch.int32))
    before = _counts()
    fb, zb = render_accumulated(sc.tworld, sc.meta, sc.cfg,
                                *sc.frame_args(1), samples=samples)
    torch.cuda.synchronize()
    assert _delta(before) == (0, 0, 0, 0, 1, 1, 0, 0, 0)
    assert torch.equal(zb.view(torch.int32), z_k.view(torch.int32).reshape(
        48, 64))
    assert torch.equal(fb, blur.dof_blur_plain(fb_k.reshape(48, 64), zb))


def test_stress_kernel_matches_plain(dev):
    sc = stress_scene(160, 90, dev)
    ifrom, rays, seeds, sec = _frame_inputs(sc, 0, dev)
    before = _counts()
    fb_k, z_k = tracer.trace_wave(sc.tworld, sc.cfg, ifrom, rays, seeds,
                                  sec, pack=True)
    assert _delta(before) == (1, 0, 0, 0, 0, 0, 0, 0, 0)
    fb_p, z_p = tracer.trace_wave_plain(sc.tworld, sc.cfg, ifrom, rays,
                                        seeds, sec, pack=True)
    assert torch.equal(fb_k, fb_p)
    assert torch.equal(z_k.view(torch.int32), z_p.view(torch.int32))


def test_probe_kernels_match_plain(dev):
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(3 * 64 + 1, 128)).astype(np.float32)).to(dev)
    before = probes.LAUNCHES_ADD_ONE
    got = probes.add_one(probes.add_one(x))
    assert probes.LAUNCHES_ADD_ONE == before + 2
    want = probes.add_one_plain(probes.add_one_plain(x))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    a = plane(dev)
    # as many blocks as the card has SMs, as the probe runs it
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for variant in probes.OPS_PER_UPDATE:
        for S in probes.S_VALUES:
            before = probes.LAUNCHES_VPU
            got = probes.vpu_chains(a, variant, S, 2, sms)
            assert probes.LAUNCHES_VPU == before + 1
            want = probes.vpu_chains_plain(a, variant, S, 2, sms)
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("world", ["flagship", "stress", "maze",
                                   "spheres64"])
def test_fused_kernel_matches_plain(dev, world):
    """96x54 fused frames (the flagship, the portal chain, the paged maze
    and the 64-sphere world): the fused instance against the plain fused
    loop bit for bit, its zbuf against the unfused kernel's."""
    if world == "flagship":
        sc = flagship_scene(96, 54, dev, fused=True)
    elif world == "spheres64":
        sc = spheres_scene(64, 96, 54, dev, fused=True)
    elif world == "stress":
        sc = stress_scene(96, 54, dev, fused=True)
    else:
        sc = maze_scene(96, 54, dev, fused=True)
        sc.cam = portal_camera(sc)
    ifrom, rays, seeds, sec = _frame_inputs(sc, 1, dev)
    page0 = sc.cfg.cam_page
    before = _counts()
    fb_k, z_k = tracer.trace_wave(sc.tworld, sc.cfg, ifrom, rays, seeds,
                                  sec, pack=True, page0=page0)
    assert _delta(before) == (0, 0, 0, 0, 0, 0, 0, 1, 0)
    fb_p, z_p = tracer.trace_wave_plain(sc.tworld, sc.cfg, ifrom, rays,
                                        seeds, sec, pack=True, page0=page0)
    assert torch.equal(fb_k, fb_p)
    assert torch.equal(z_k.view(torch.int32), z_p.view(torch.int32))
    unfused = dataclasses.replace(sc.cfg, fused=False)
    _, z_u = tracer.trace_wave(sc.tworld, unfused, ifrom, rays, seeds, sec,
                               pack=True, page0=page0)
    assert torch.equal(z_k.view(torch.int32), z_u.view(torch.int32))
    before = _counts()
    render_frame(sc.tworld, sc.meta, sc.cfg, *sc.frame_args(1))
    torch.cuda.synchronize()
    assert _delta(before) == (0, 0, 0, 0, 0, 1, 0, 1, 0)


# each rendering instance's RenderConfig fields on a one-page world, and
# the position of its launch counter in _counts()
INSTANCE_CFG = {"fast": ({}, 0), "samples": ({"samples": 2}, 2),
                "parity": ({"parity": True}, 3),
                "parity_samples": ({"parity": True, "samples": 2}, 4),
                "fused": ({"fused": True}, 7)}


@pytest.mark.parametrize("instance", list(INSTANCE_CFG))
def test_64_sphere_instances_match_plain(dev, instance):
    """The world of 64 spheres, the object pool's capacity
    (scene.spheres_scene), through each rendering instance at 96x54 on
    the second frame of its camera path: one launch of the instance,
    bit-equal to the plain tracer."""
    kw, slot = INSTANCE_CFG[instance]
    sc = spheres_scene(64, 96, 54, dev, **kw)
    assert sc.tworld.n_spheres == 64
    ifrom, rays, seeds, sec = _frame_inputs(sc, 1, dev)
    before = _counts()
    fb_k, z_k = tracer.trace_wave(sc.tworld, sc.cfg, ifrom, rays, seeds,
                                  sec, pack=True)
    assert _delta(before) == tuple(int(k == slot) for k in range(9))
    fb_p, z_p = tracer.trace_wave_plain(sc.tworld, sc.cfg, ifrom, rays,
                                        seeds, sec, pack=True)
    assert torch.equal(fb_k, fb_p)
    assert torch.equal(z_k.view(torch.int32), z_p.view(torch.int32))


@pytest.mark.parametrize("view,samples", [("portal", 1), ("path", 1),
                                          ("portal", 2)])
def test_paged_parity_kernel_matches_plain(dev, view, samples):
    """96x54 parity frames of the maze: the kernel against the plain
    parity tracer on the card (and, at one sample, on the host's CPU);
    render_frame launches it once."""
    sc = maze_scene(96, 54, dev, parity=True, samples=samples)
    if view == "portal":
        sc.cam = portal_camera(sc)
    ifrom, rays, seeds, sec = _frame_inputs(sc, 0, dev)
    page0 = sc.cfg.cam_page
    before = _counts()
    fb_k, z_k = tracer.trace_wave(sc.tworld, sc.cfg, ifrom, rays, seeds,
                                  sec, pack=True, page0=page0)
    assert _delta(before) == (0, 0, 0, 0, 0, 0, 0, 0, 1)
    fb_p, z_p = tracer.trace_wave_plain(sc.tworld, sc.cfg, ifrom, rays,
                                        seeds, sec, pack=True, page0=page0)
    assert torch.equal(fb_k, fb_p)
    assert torch.equal(z_k.view(torch.int32), z_p.view(torch.int32))
    if samples == 1:
        host = maze_scene(96, 54, "cpu", parity=True)
        host.cam = sc.cam
        fb_h, z_h = tracer.trace_wave(host.tworld, host.cfg,
                                      *_frame_inputs(host, 0, "cpu"),
                                      pack=True, page0=page0)
        assert torch.equal(fb_k.cpu(), fb_h)
        assert torch.equal(z_k.cpu().view(torch.int32),
                           z_h.view(torch.int32))
    before = _counts()
    render_frame(sc.tworld, sc.meta, sc.cfg, *sc.frame_args(0))
    torch.cuda.synchronize()
    assert _delta(before) == (0, 0, 0, 0, 0, 1, 0, 0, 1)


def test_ring_atlas_parity_equals_one_page_chain(dev):
    """The chain on three pages, each portal leading to the next page:
    its parity frame equals the one-page chain's, kernel against
    kernel."""
    ring = ring_scene(160, 90, dev, parity=True)
    one = stress_scene(160, 90, dev, parity=True)
    before = _counts()
    fb_r, z_r = tracer.trace_wave(ring.tworld, ring.cfg,
                                  *_frame_inputs(ring, 0, dev), pack=True)
    fb_o, z_o = tracer.trace_wave(one.tworld, one.cfg,
                                  *_frame_inputs(one, 0, dev), pack=True)
    assert _delta(before) == (0, 0, 0, 1, 0, 0, 0, 0, 1)
    assert torch.equal(fb_r, fb_o)
    assert torch.equal(z_r.view(torch.int32), z_o.view(torch.int32))


@pytest.mark.parametrize("variant", list(tracer.VARIANTS))
@pytest.mark.parametrize("world", ["flagship", "maze"])
def test_variant_kernels_match_plain(dev, variant, world):
    """Each measurement instance equals the plain tracer in fb, zbuf and
    (profile) the per-wave tstep; each probe also equals the base
    kernel, and nowater differs from it only in colour."""
    if world == "flagship":
        sc = flagship_scene(160, 90, dev)
    else:
        sc = maze_scene(160, 90, dev)
        sc.cam = portal_camera(sc)
    kw = {"profile": dict(profile=True), "nowater": dict(water=False)}.get(
        variant, dict(probe=variant))
    cfg = dataclasses.replace(sc.cfg, **kw)
    ifrom, rays, seeds, sec = _frame_inputs(sc, 0, dev)
    page0 = sc.cfg.cam_page
    before = dict(tracer.LAUNCHES_VARIANT)
    if variant == "profile":
        fb_k, z_k, t_k = tracer.trace_wave_profile(
            sc.tworld, cfg, ifrom, rays, seeds, sec, page0=page0)
        segs = []
        fb_p, z_p = tracer.trace_wave_plain(sc.tworld, cfg, ifrom, rays,
                                            seeds, sec, True, page0=page0,
                                            segs=segs)
        assert torch.equal(t_k, torch.stack([o.tstep for o in segs]))
    else:
        fb_k, z_k = tracer.trace_wave(sc.tworld, cfg, ifrom, rays, seeds,
                                      sec, pack=True, page0=page0)
        fb_p, z_p = tracer.trace_wave_plain(sc.tworld, cfg, ifrom, rays,
                                            seeds, sec, True, page0=page0)
    assert tracer.LAUNCHES_VARIANT[variant] == before[variant] + 1
    assert torch.equal(fb_k, fb_p)
    assert torch.equal(z_k.view(torch.int32), z_p.view(torch.int32))
    fb_b, z_b = tracer.trace_wave(sc.tworld, sc.cfg, ifrom, rays, seeds, sec,
                                  pack=True, page0=page0)
    assert torch.equal(z_k.view(torch.int32), z_b.view(torch.int32))
    if variant != "nowater":
        assert torch.equal(fb_k, fb_b)


@pytest.mark.parametrize("parity", [False, True])
def test_game_session_on_the_card(dev, parity):
    """The session renders on the card through one tracer and one blur
    launch a frame; its trace equals the plain tracer's on the card."""
    from pwnfps_tpu_torch.core.config import RenderConfig
    from pwnfps_tpu_torch.host.loop import GameSession
    from pwnfps_tpu_torch.host.physics import Keys
    from pwnfps_tpu_torch.ops.world import world_to_torch

    w, h = 64, 40
    sess = GameSession(cfg=RenderConfig(width=w, height=h, parity=parity),
                       device=dev)
    for _ in range(3):
        sess.tick(1 / 60, Keys(forward=True, turnleft=True))
    before = _counts()
    fb, zb = sess.render()
    assert sum(_delta(before)) == 2           # one trace, one blur
    assert fb.shape == (h, w) and fb.dtype == np.uint32
    assert len(np.unique(fb)) > 8
    tworld = world_to_torch(*sess.build_world(), dev)
    ifrom, rays, seeds = sess.frame_rays()
    fb_k, z_k = tracer.trace_wave(tworld, sess.cfg, ifrom, rays, seeds,
                                  sess.sec, pack=True)
    fb_p, z_p = tracer.trace_wave_plain(tworld, sess.cfg, ifrom, rays, seeds,
                                        sess.sec, pack=True)
    assert torch.equal(fb_k, fb_p)
    assert torch.equal(z_k.view(torch.int32), z_p.view(torch.int32))


def _instance_scene(instance, w, h, dev):
    """The scene whose frame takes rendering instance `instance`."""
    if instance == "fast":
        return flagship_scene(w, h, dev)
    if instance == "fused":
        return flagship_scene(w, h, dev, fused=True)
    if instance == "samples":
        return ptrace_scene(w, h, dev, samples=2)
    if instance == "parity":
        return parity_scene(w, h, dev)
    if instance == "parity_samples":
        return parity_scene(w, h, dev, samples=2)
    sc = maze_scene(w, h, dev, parity=instance == "paged_parity")
    sc.cam = portal_camera(sc)
    return sc


@pytest.mark.parametrize("w,h,width", [(33, 17, None), (7, 5, None),
                                       (1, 1, None), (33, 17, 34)])
@pytest.mark.parametrize("instance", ["fast", "paged", "samples", "fused",
                                      "parity", "parity_samples",
                                      "paged_parity"])
def test_instances_at_ragged_shapes(dev, instance, w, h, width):
    """Each rendering instance on ragged 8x4 tiles of the w-wide image
    (33x17: the last tile column has one pixel, the last tile row one
    row; 7x5; one ray) and, where the width does not divide n (34 for
    561 rays), in runs of 32 rays: bit-equal to the plain tracer."""
    sc = _instance_scene(instance, w, h, dev)
    ifrom, rays, seeds, sec = _frame_inputs(sc, 0, dev)
    page0 = sc.cfg.cam_page
    fb_k, z_k = tracer.trace_wave(sc.tworld, sc.cfg, ifrom, rays, seeds,
                                  sec, pack=True, page0=page0, width=width)
    fb_p, z_p = tracer.trace_wave_plain(sc.tworld, sc.cfg, ifrom, rays,
                                        seeds, sec, pack=True, page0=page0)
    assert torch.equal(fb_k, fb_p)
    assert torch.equal(z_k.view(torch.int32), z_p.view(torch.int32))


@pytest.mark.parametrize("reflect", [0, 1, 6])
@pytest.mark.parametrize("samples", [2, 3, 5])
@pytest.mark.parametrize("w,h", [(34, 17), (1, 1)])
@pytest.mark.parametrize("parity", [False, True])
def test_samples_instances_at_ragged_shapes(dev, parity, w, h, samples,
                                            reflect):
    """The two samples instances, which shade the primary segment once
    and run every sample's chain from that shading, on the demo level
    with the creature's spheres in view (the flagship scene in fast
    mode, the parity scene in parity mode) at ragged tiles (34x17) and
    one ray: bit-equal to the plain tracer at every sample count and
    depth (reflect 0: no chain bounces)."""
    make = parity_scene if parity else flagship_scene
    sc = make(w, h, dev, samples=samples, reflect=reflect)
    ifrom, rays, seeds, sec = _frame_inputs(sc, 1, dev)
    before = _counts()
    fb_k, z_k = tracer.trace_wave(sc.tworld, sc.cfg, ifrom, rays, seeds,
                                  sec, pack=True)
    assert _delta(before) == ((0, 0, 0, 0, 1, 0, 0, 0, 0) if parity
                              else (0, 0, 1, 0, 0, 0, 0, 0, 0))
    fb_p, z_p = tracer.trace_wave_plain(sc.tworld, sc.cfg, ifrom, rays,
                                        seeds, sec, pack=True)
    assert torch.equal(fb_k, fb_p)
    assert torch.equal(z_k.view(torch.int32), z_p.view(torch.int32))


@pytest.mark.parametrize("parity", [False, True])
def test_samples_instances_on_the_paged_maze(dev, parity):
    """Both samples instances on the paged maze at 34x17 from its
    portal camera, samples 2: bit-equal to the plain tracer."""
    sc = maze_scene(34, 17, dev, parity=parity, samples=2)
    sc.cam = portal_camera(sc)
    ifrom, rays, seeds, sec = _frame_inputs(sc, 0, dev)
    page0 = sc.cfg.cam_page
    fb_k, z_k = tracer.trace_wave(sc.tworld, sc.cfg, ifrom, rays, seeds,
                                  sec, pack=True, page0=page0)
    fb_p, z_p = tracer.trace_wave_plain(sc.tworld, sc.cfg, ifrom, rays,
                                        seeds, sec, pack=True, page0=page0)
    assert torch.equal(fb_k, fb_p)
    assert torch.equal(z_k.view(torch.int32), z_p.view(torch.int32))


@pytest.mark.parametrize("w,h,width", [(33, 17, None), (7, 5, None),
                                       (1, 1, None), (33, 17, 34)])
@pytest.mark.parametrize("pages", [2, 4, 12])
def test_paged_fast_instance_on_atlases(dev, pages, w, h, width):
    """The paged fast instance (trace_kernel<false, false, false, 0,
    false>, which fast mode launches for every world of more than one
    page) on sector-maze atlases of 2, 4 (config #3) and 12 pages from
    the portal camera, at ragged 8x4 tiles (33x17), 7x5, one ray and,
    where the width does not divide n, in runs of 32 rays: one paged
    launch, bit-equal to the plain tracer."""
    sc = maze_scene(w, h, dev, pages=pages)
    sc.cam = portal_camera(sc)
    assert sc.tworld.n_pages == pages
    ifrom, rays, seeds, sec = _frame_inputs(sc, 0, dev)
    page0 = sc.cfg.cam_page
    before = tracer.LAUNCHES_PAGED
    fb_k, z_k = tracer.trace_wave(sc.tworld, sc.cfg, ifrom, rays, seeds,
                                  sec, pack=True, page0=page0, width=width)
    assert tracer.LAUNCHES_PAGED == before + 1
    fb_p, z_p = tracer.trace_wave_plain(sc.tworld, sc.cfg, ifrom, rays,
                                        seeds, sec, pack=True, page0=page0)
    assert torch.equal(fb_k, fb_p)
    assert torch.equal(z_k.view(torch.int32), z_p.view(torch.int32))


def test_side_stream_and_graph_capture(dev):
    """Every launch route on a side stream and captured into a CUDA
    graph (the capture stream): add_one, dof_blur, and trace_wave in
    its one-chain instance and in its persistent samples instance, whose
    tile queue belongs to the stream.  Each equals its plain version
    after the side-stream launch and after each of two replays; a
    captured launch counts once, replays never."""
    x = torch.from_numpy(np.random.default_rng(7).normal(
        size=(65, 128)).astype(np.float32)).to(dev)
    fl = flagship_scene(64, 32, dev)
    pt = ptrace_scene(64, 32, dev)
    ins = {name: _frame_inputs(sc, 1, dev) for name, sc in
           (("fast", fl), ("samples", pt))}
    fb0, z0 = tracer.trace_wave_plain(fl.tworld, fl.cfg, *ins["fast"],
                                      pack=True)
    fb0, z0 = fb0.view(32, 64), z0.view(32, 64)

    def trace(sc, name):
        return lambda: tracer.trace_wave(sc.tworld, sc.cfg, *ins[name],
                                         pack=True)
    calls = {"add_one": (lambda: probes.add_one(x),
                         lambda: probes.add_one_plain(x)),
             "dof_blur": (lambda: blur.dof_blur(fb0, z0),
                          lambda: blur.dof_blur_plain(fb0, z0)),
             "fast": (trace(fl, "fast"), lambda: (fb0.view(-1), z0.view(-1))),
             "samples": (trace(pt, "samples"),
                         lambda: tracer.trace_wave_plain(
                             pt.tworld, pt.cfg, *ins["samples"], pack=True))}

    counter = {"add_one": lambda: probes.LAUNCHES_ADD_ONE,
               "dof_blur": lambda: blur.LAUNCHES,
               "fast": lambda: tracer.LAUNCHES,
               "samples": lambda: tracer.LAUNCHES_SAMPLES}

    def bits(out):
        return [t.view(torch.int32) for t in (
            out if isinstance(out, tuple) else (out,))]

    def same(a, b):
        assert all(torch.equal(p, q) for p, q in zip(bits(a), bits(b)))

    for name, (fn, plain) in calls.items():
        want = plain()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            got = fn()
        side.synchronize()
        same(got, want)
        graph = torch.cuda.CUDAGraph()
        before = counter[name]()
        with torch.cuda.graph(graph):
            out = fn()
        assert counter[name]() == before + 1, name
        for _ in range(2):
            graph.replay()
            torch.cuda.synchronize()
            same(out, want)
        assert counter[name]() == before + 1, name


def test_launch_errors_raise(dev):
    """A C entry point that refuses its arguments or fails its launch
    makes the wrapper raise, and later launches still work: vpu_chains at
    an S with no instance, and a trace deeper than the kernel's wave
    records."""
    a = plane(dev)
    out = torch.empty((1, 8, 128), device=dev)
    with pytest.raises(RuntimeError, match="CUDA error"):
        probes._VPU_CHAINS(dev.index, a.data_ptr(), out.data_ptr(), 0, 3, 1,
                           1, probes.MUL, probes.ADD)
    sc = flagship_scene(8, 4, dev, reflect=8)
    with pytest.raises(RuntimeError, match="CUDA error"):
        tracer.trace_wave(sc.tworld, sc.cfg, *_frame_inputs(sc, 0, dev),
                          pack=True)
    x = torch.ones(64, device=dev)
    assert torch.equal(probes.add_one(x), x + 1)


@pytest.mark.parametrize("instance", ["fast", "samples", "fused", "parity",
                                      "parity_samples"])
def test_two_launches_and_two_streams(dev, instance):
    """Two launches in a row on one stream, then one on each of two
    streams at once, of each instance at 480x288: 4,320 tiles, more
    than the persistent instances (samples, fused, parity samples) keep
    warps resident, so their warps take tiles off the queue, which each
    launch must leave reset and which two streams must not share; the
    one-chain instances (fast, parity) launch a warp a tile.  Each
    equals the plain trace."""
    sc = _instance_scene(instance, 480, 288, dev)
    n = 480 * 288
    n_tiles = len(tracer.warp_tiles(n, 480))
    shape = tracer.launch_shape(sc.cfg, n, 480, sc.tworld.n_pages, dev)
    warps = shape["blocks"] * shape["threads"] // tracer.WARP
    if instance in ("fast", "parity"):
        assert warps >= n_tiles, shape
    else:
        assert warps < n_tiles, (shape, n_tiles)
    ifrom, rays, seeds, sec = _frame_inputs(sc, 1, dev)
    fb_p, z_p = tracer.trace_wave_plain(sc.tworld, sc.cfg, ifrom, rays,
                                        seeds, sec, pack=True)

    def trace():
        return tracer.trace_wave(sc.tworld, sc.cfg, ifrom, rays, seeds, sec,
                                 pack=True)
    outs = [trace(), trace()]
    streams = [torch.cuda.Stream(dev), torch.cuda.Stream(dev)]
    torch.cuda.synchronize()
    for st in streams:
        with torch.cuda.stream(st):
            outs.append(trace())
    torch.cuda.synchronize()
    for fb, z in outs:
        assert torch.equal(fb, fb_p)
        assert torch.equal(z.view(torch.int32), z_p.view(torch.int32))


def _frame_line(log: str, tag: str) -> tuple:
    """(stack frame, spill stores, spill loads) bytes of the kernel whose
    mangled name holds tag, from the `-Xptxas -v` report."""
    on = False
    for ln in log.splitlines():
        if "Compiling entry function" in ln or "Function properties" in ln:
            on = tag in ln
        elif on and "stack frame" in ln:
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", ln)
            return tuple(int(g) for g in m.groups())
    raise AssertionError(f"no ptxas report for {tag}:\n{log}")


def test_unwind_records_off_the_stack(dev):
    """ptxas: the fast one-page instance (trace_kernel<false, false,
    false, 0, true>) spills nothing and keeps at most the 32 bytes that
    the device sinf/cosf reserve for their large-argument reduction, and
    the nowater instance, which calls neither, no stack frame at all; the
    fused instance, in its 128-thread blocks, spills nothing; the
    flagship launch keeps 24 warps an SM resident (two blocks of 384
    threads)."""
    _build.build_all(["tracer", "tracer_variants"])
    frame, st, ld = _frame_line(_build.PTXAS_LOG["tracer"],
                                "ILb0ELb0ELb0ELi0ELb1EE")
    assert frame <= 32 and st == ld == 0, (frame, st, ld)
    fused = _frame_line(_build.PTXAS_LOG["tracer"], "ILb0ELb0ELb1ELi0ELb1EE")
    assert fused[1:] == (0, 0), fused
    fshape = tracer.launch_shape(flagship_scene(8, 8, dev, fused=True).cfg,
                                 1920 * 1080, 1920, 1, dev)
    assert fshape["threads"] == 128, fshape
    nowater = _frame_line(_build.PTXAS_LOG["tracer_variants"],
                          f"ILb0ELb0ELb0ELi{tracer.VARIANTS['nowater']}ELb1EE")
    assert nowater == (0, 0, 0), nowater
    shape = tracer.launch_shape(flagship_scene(8, 8, dev).cfg, 1920 * 1080,
                                1920, 1, dev)
    assert shape["blocks_per_sm"] * shape["threads"] == 24 * 32, shape


def _registers(log: str, tag: str) -> int:
    """Registers of the kernel whose mangled name holds tag, from the
    `-Xptxas -v` report."""
    on = False
    for ln in log.splitlines():
        if "Compiling entry function" in ln or "Function properties" in ln:
            on = tag in ln
        elif on and "registers" in ln:
            return int(re.search(r"Used (\d+) registers", ln).group(1))
    raise AssertionError(f"no ptxas report for {tag}:\n{log}")


# The rendering instances with S = false (one chain a ray), as ptxas
# reported them (nvcc 12.8 for sm_90a; registers, stack frame, spill
# stores, spill loads), since both modes step through one function with
# one branch an outcome (step_core) and fast mode takes its sphere roots
# lazily: the fast instances in 384-thread blocks under
# __launch_bounds__(384, 2) (at most 80 registers), the fused loop's
# 128-thread ones, the parity instances' 448-thread ones (at most 72);
# no spill.
ONE_CHAIN_PTXAS = {
    "ILb0ELb0ELb0ELi0ELb1EE": (79, 32, 0, 0),      # fast, one page
    "ILb0ELb0ELb0ELi0ELb0EE": (79, 32, 0, 0),      # fast, paged
    "ILb0ELb0ELb1ELi0ELb1EE": (91, 32, 0, 0),      # fused, one page
    "ILb0ELb0ELb1ELi0ELb0EE": (87, 32, 0, 0),      # fused, paged
    "ILb1ELb0ELb0ELi0ELb1EE": (67, 0, 0, 0),       # parity, one page
    "ILb1ELb0ELb0ELi0ELb0EE": (67, 0, 0, 0),       # parity, paged
}


def test_one_chain_instances_compile_as_before(dev):
    _build.build_all(["tracer"])
    log = _build.PTXAS_LOG["tracer"]
    for tag, want in ONE_CHAIN_PTXAS.items():
        assert (_registers(log, tag), *_frame_line(log, tag)) == want, tag


# The blur kernel's instances (csrc/blur.cu dof_blur_tiles<TW, TH>), as
# ptxas reported them (nvcc 12.8 for sm_90a; registers, stack frame,
# spill stores, spill loads): no stack, no spill; the 64 x 32 instance,
# the one that stages a tap window, at the 64 registers that four blocks
# of 256 threads an SM leave each thread.
BLUR_PTXAS = {
    "dof_blur_tilesILi64ELi32E": (64, 0, 0, 0),
    "dof_blur_tilesILi64ELi16E": (48, 0, 0, 0),
    "dof_blur_tilesILi32ELi32E": (48, 0, 0, 0),
    "dof_blur_tilesILi32ELi16E": (48, 0, 0, 0),
}


def test_blur_instances_compile_as_recorded(dev):
    _build.build_all(["blur"])
    log = _build.PTXAS_LOG["blur"]
    for tag, want in BLUR_PTXAS.items():
        assert (_registers(log, tag), *_frame_line(log, tag)) == want, tag


@pytest.mark.parametrize("name", list(ieee_check.SETS))
def test_ieee_intrinsics_equal_integer_emulations(dev, name):
    """The parity instances' __fsqrt_rn and __fdiv_rn give the bits of
    core/ieee.py's integer sqrt_rn and div_rn (csrc/ieee_check.cu) over
    every positive normal f32, 2^28 random pairs and the edge sets."""
    r = ieee_check.check(name, dev)
    assert r["pairs"] == ieee_check.SETS[name][1], r
    assert r["mismatches"] == 0, r


# the parity instances' threads a block and blocks an SM, by samples > 1
# (csrc/tracer_body.cuh Block<true, S, false>)
PARITY_BLOCK = {False: (448, 2), True: (320, 2)}


@pytest.mark.parametrize("world,samples,reflect", [
    ("one_page", 1, 2), ("one_page", 4, 6), ("paged", 1, 2),
    ("paged", 2, 2)])
def test_parity_launch_shape(dev, world, samples, reflect):
    """The parity instances' dynamic shared memory a block, in words:
    on a one-page world its cell tables (2 x 4096), then on either
    world the 64 sphere records (64 x 16), the compact SSE tables (2048
    words, 8 KB) and the unwind records (6 a wave a thread); two blocks
    an SM, the one-chain instance's 448-thread blocks at BASELINE config
    #1's reflect 2 and the samples instance's 320-thread ones up to
    config #5's reflect 6.  The one-chain instance launches a block for
    every 14 tiles, the samples instance no more than stay resident."""
    make = parity_scene if world == "one_page" else maze_scene
    kw = {} if world == "one_page" else {"parity": True}
    sc = make(64, 48, dev, samples=samples, reflect=reflect, **kw)
    threads, per_sm = PARITY_BLOCK[samples > 1]
    shape = tracer.launch_shape(sc.cfg, 64 * 48, 64, sc.tworld.n_pages,
                                dev)
    cells = 2 * 4096 if world == "one_page" else 0
    words = cells + 64 * 16 + 2048 + (reflect + 1) * 6 * threads
    assert shape["smem_bytes"] == 4 * words, shape
    assert shape["threads"] == threads, shape
    assert shape["blocks_per_sm"] == per_sm, shape
    n_tiles = len(tracer.warp_tiles(64 * 48, 64))
    if samples == 1:
        assert shape["blocks"] == -(-n_tiles // (threads // 32)), shape


@pytest.mark.parametrize("reflect", [2, 6])
def test_parity_fuzz_rays_match_plain(dev, reflect):
    """The one-page parity instance on 20,000 seeded rays through the
    fuzz level (scene.fuzz_rays: portals, one of them turning the ray,
    ramps, fog, 2-high cells with '"' links, spheres behind portals and
    in fog), rays that are no image: fb and zbuf bit for bit the plain
    tracer's, at BASELINE config #1's reflect 2 and config #5's 6.  The
    parity step's branches that the demo-level frames never take."""
    wt, cfg, ifrom, rays, seeds = fuzz_rays(20000, dev, seed=reflect,
                                            reflect=reflect)
    sec = np.float32(0.25)
    before = tracer.LAUNCHES_PARITY
    fb_k, z_k = tracer.trace_wave(wt, cfg, ifrom, rays, seeds, sec,
                                  pack=True, width=0)
    assert tracer.LAUNCHES_PARITY == before + 1
    fb_p, z_p = tracer.trace_wave_plain(wt, cfg, ifrom, rays, seeds, sec,
                                        pack=True)
    assert len(torch.unique(fb_p)) > 1000
    msg = (f"fb differs on {(fb_k != fb_p).sum().item()} rays, zbuf on "
           f"{(z_k.view(torch.int32) != z_p.view(torch.int32)).sum().item()}")
    assert torch.equal(fb_k, fb_p), msg
    assert torch.equal(z_k.view(torch.int32), z_p.view(torch.int32)), msg


@pytest.mark.parametrize("world", ["one_page", "paged"])
def test_phases_instance_matches_parity(dev, world):
    """The phases instance (ops/tracer.trace_wave_phases) gives the parity
    instance's bits, on a one-page and a paged world, and counts cycles
    in every region; a warp's kernel cycles hold its prologue and its
    tile."""
    if world == "one_page":
        sc = parity_scene(96, 64, dev)
    else:
        sc = maze_scene(96, 54, dev, parity=True)
        sc.cam = portal_camera(sc)
    ifrom, rays, seeds, sec = _frame_inputs(sc, 0, dev)
    call = (sc.tworld, sc.cfg, ifrom, rays, seeds, sec)
    page0 = sc.cfg.cam_page
    before = tracer.LAUNCHES_PHASES
    fb_q, z_q, cycles = tracer.trace_wave_phases(*call, page0=page0)
    assert tracer.LAUNCHES_PHASES == before + 1
    fb_k, z_k = tracer.trace_wave(*call, pack=True, page0=page0)
    assert torch.equal(fb_q, fb_k)
    assert torch.equal(z_q.view(torch.int32), z_k.view(torch.int32))
    c = dict(zip(tracer.PHASES, cycles.tolist()))
    assert all(v > 0 for v in c.values()), c
    assert c["kernel"] >= c["prologue"] + c["tile"], c
    with pytest.raises(ValueError):
        tracer.trace_wave_phases(sc.tworld, dataclasses.replace(
            sc.cfg, samples=2), *call[2:], page0=page0)


@pytest.mark.parametrize("world", ["one_page", "paged"])
def test_fast_phases_instance_matches_kernel(dev, world):
    """Fast mode's phases instance gives the bits of the one-chain fast
    instance of its world (one page: the flagship; paged: the maze from
    its portal camera) and counts cycles in every region; the fused
    loop has none."""
    if world == "one_page":
        sc = flagship_scene(96, 64, dev)
    else:
        sc = maze_scene(96, 54, dev)
        sc.cam = portal_camera(sc)
    ifrom, rays, seeds, sec = _frame_inputs(sc, 0, dev)
    call = (sc.tworld, sc.cfg, ifrom, rays, seeds, sec)
    page0 = sc.cfg.cam_page
    fb_q, z_q, cycles = tracer.trace_wave_phases(*call, page0=page0)
    fb_k, z_k = tracer.trace_wave(*call, pack=True, page0=page0)
    assert torch.equal(fb_q, fb_k)
    assert torch.equal(z_q.view(torch.int32), z_k.view(torch.int32))
    c = dict(zip(tracer.PHASES, cycles.tolist()))
    assert all(v > 0 for v in c.values()), c
    with pytest.raises(ValueError):
        tracer.trace_wave_phases(sc.tworld, dataclasses.replace(
            sc.cfg, fused=True), *call[2:], page0=page0)


# the rendering instances and their scenes, for the unpacked colour
UNPACKED = {"fast": ("flagship", {}), "paged": ("maze", {}),
            "samples": ("ptrace", {"samples": 2}),
            "fused": ("flagship", {"fused": True}),
            "fused_paged": ("maze", {"fused": True}),
            "parity": ("parity", {}),
            "parity_samples": ("parity", {"samples": 2}),
            "parity_paged": ("maze_parity", {})}


def _scene14(name, dev, w=64, h=48):
    if name == "flagship":
        return flagship_scene(w, h, dev)
    if name == "parity":
        return parity_scene(w, h, dev)
    if name == "ptrace":
        return ptrace_scene(w, h, dev, samples=2)
    sc = maze_scene(w, h, dev, parity=name == "maze_parity")
    sc.cam = portal_camera(sc)
    return sc


def _bits_equal(a, b) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("instance", list(UNPACKED))
def test_unpacked_colour_matches_plain(dev, instance):
    """pack=False on every rendering instance: the C4 and dist equal the
    plain tracer's bit for bit, col_ftoint of the C4 equals the packed
    launch's fb, and the launch counts in LAUNCHES_UNPACKED."""
    name, kw = UNPACKED[instance]
    sc = _scene14(name, dev)
    cfg = dataclasses.replace(sc.cfg, **kw)
    ifrom, rays, seeds, sec = _frame_inputs(sc, 1, dev)
    page0 = cfg.cam_page
    key = tracer.instance(cfg, sc.tworld.n_pages)[1]
    before = tracer.LAUNCHES_UNPACKED[key]
    col, dist = tracer.trace_wave(sc.tworld, cfg, ifrom, rays, seeds, sec,
                                  page0=page0)
    assert tracer.LAUNCHES_UNPACKED[key] == before + 1
    col_p, dist_p = tracer.trace_wave_plain(sc.tworld, cfg, ifrom, rays,
                                            seeds, sec, page0=page0)
    assert all(_bits_equal(a, b) for a, b in zip(col, col_p))
    assert _bits_equal(dist, dist_p)
    fb, dist_k = tracer.trace_wave(sc.tworld, cfg, ifrom, rays, seeds, sec,
                                   pack=True, page0=page0)
    assert torch.equal(col_ftoint(col), fb)
    assert _bits_equal(dist_k, dist)


KNOBS = {"nowater": dict(water=False), "profile": dict(profile=True),
         **{p: dict(probe=p) for p in tracer.PROBES}}
# the knob combinations of the run-time-flag instances: (scene, fields)
COMBOS = {
    "samples_nowater": ("ptrace", dict(samples=2, water=False)),
    "samples_profile": ("ptrace", dict(samples=2, profile=True)),
    "samples_pad64": ("ptrace", dict(samples=2, probe="pad64")),
    "parity_samples_nowater": ("parity", dict(samples=2, water=False)),
    "parity_samples_fire1": ("parity", dict(samples=2, probe="fire1")),
    "fused_nowater": ("flagship", dict(fused=True, water=False)),
    **{f"fused_{p}": ("flagship", dict(fused=True, probe=p))
       for p in tracer.PROBES},
    "fused_paged_sel64": ("maze", dict(fused=True, probe="sel64")),
    "profile_nowater_pad64": ("flagship", dict(profile=True, water=False,
                                               probe="pad64")),
    "parity_profile_nowater_pad64": ("parity", dict(
        profile=True, water=False, probe="pad64")),
    "paged_parity_nowater_fetch2x": ("maze_parity", dict(
        water=False, probe="fetch2x")),
}


def _knob_check(dev, name, kw):
    """The instance the knobs select against plain: fb, zbuf and, where
    there is one, tstep bit for bit; a probe also leaves the bits of the
    same knobs without it.  Returns the (entry, counter) it launched."""
    sc = _scene14(name, dev)
    cfg = dataclasses.replace(sc.cfg, **kw)
    ifrom, rays, seeds, sec = _frame_inputs(sc, 0, dev)
    page0 = cfg.cam_page
    entry, key = tracer.instance(cfg, sc.tworld.n_pages)
    counters = {"variant": tracer.LAUNCHES_VARIANT,
                "parity_variant": tracer.LAUNCHES_PARITY_VARIANT,
                "flags": tracer.LAUNCHES_FLAGS}
    before = counters[entry][key] if entry in counters else None
    if "profile" in tracer.variant(cfg):
        fb_k, z_k, t_k = tracer.trace_wave_profile(
            sc.tworld, cfg, ifrom, rays, seeds, sec, page0=page0)
        segs = []
        fb_p, z_p = tracer.trace_wave_plain(sc.tworld, cfg, ifrom, rays,
                                            seeds, sec, True, page0=page0,
                                            segs=segs)
        assert torch.equal(t_k, torch.stack([o.tstep for o in segs]))
    else:
        fb_k, z_k = tracer.trace_wave(sc.tworld, cfg, ifrom, rays, seeds,
                                      sec, pack=True, page0=page0)
        fb_p, z_p = tracer.trace_wave_plain(sc.tworld, cfg, ifrom, rays,
                                            seeds, sec, True, page0=page0)
    if before is not None:
        assert counters[entry][key] == before + 1
    assert torch.equal(fb_k, fb_p)
    assert _bits_equal(z_k, z_p)
    if cfg.probe:
        fb_b, z_b = tracer.trace_wave(sc.tworld, dataclasses.replace(
            cfg, probe=""), ifrom, rays, seeds, sec, pack=True, page0=page0)
        assert torch.equal(fb_k, fb_b)
        assert _bits_equal(z_k, z_b)
    return entry, key


@pytest.mark.parametrize("knob", list(KNOBS))
@pytest.mark.parametrize("world", ["parity", "maze_parity"])
def test_parity_variant_kernels_match_plain(dev, knob, world):
    """Each knob in parity mode, one sample: its instance of
    tracer_parity_variants.cu equals the plain parity tracer."""
    assert _knob_check(dev, world, KNOBS[knob])[0] == "parity_variant"


@pytest.mark.parametrize("combo", list(COMBOS))
def test_flag_instances_match_plain(dev, combo):
    """The knobs with samples 2, with the fused loop and several at once:
    the run-time-flag instance of the structure equals plain (samples
    with profile alone takes the samples instance: no tstep exists)."""
    name, kw = COMBOS[combo]
    entry, key = _knob_check(dev, name, kw)
    assert entry == ("tracer" if combo == "samples_profile" else "flags")


# The new measurement instances, as ptxas reported them (nvcc 12.8 for
# sm_90a; registers, stack frame, spill stores, spill loads), since the
# one-branch step and the fast one-chain instances' 384-thread blocks:
# parity mode's one-knob instances (448 x 2 blocks: at most 72
# registers) by VAR_*, and the run-time-flag instances (VAR_FLAGS = 12)
# by <P, S, F> (fast one chain 384 x 2: at most 80; the fast ones with
# fire1's refresh taking every sphere's roots), each (one page, paged).
PARITY_VARIANT_PTXAS = {1: ((67, 0, 0, 0),) * 2,
                        2: ((70, 32, 0, 0), (71, 32, 0, 0)),
                        3: ((68, 0, 0, 0),) * 2, 4: ((67, 0, 0, 0),) * 2,
                        5: ((72, 16, 24, 16),) * 2, 6: ((72, 0, 0, 0),) * 2,
                        7: ((72, 16, 24, 16),) * 2, 8: ((71, 0, 0, 0),) * 2,
                        9: ((71, 0, 0, 0),) * 2,
                        10: ((72, 16, 24, 16),) * 2}
FLAGS_PTXAS = {"ILb0ELb0ELb0ELi12E": ((80, 80, 28, 36), (80, 96, 32, 40)),
               "ILb0ELb1ELb0ELi12E": ((96, 40, 8, 8), (96, 48, 20, 16)),
               "ILb0ELb0ELb1ELi12E": ((100, 32, 0, 0), (99, 32, 0, 0)),
               "ILb1ELb0ELb0ELi12E": ((72, 64, 36, 44),) * 2,
               "ILb1ELb1ELb0ELi12E": ((96, 0, 0, 0),) * 2}


def test_new_measurement_instances_compile_as_recorded(dev):
    _build.build_all(["tracer_parity_variants", "tracer_flags"])
    log = _build.PTXAS_LOG["tracer_parity_variants"]
    for v, want in PARITY_VARIANT_PTXAS.items():
        for t in (1, 0):
            tag = f"ILb1ELb0ELb0ELi{v}ELb{t}EE"
            assert (_registers(log, tag), *_frame_line(log, tag)) \
                == want[1 - t], tag
    log = _build.PTXAS_LOG["tracer_flags"]
    for tag, want in FLAGS_PTXAS.items():
        for t in (1, 0):
            got = (_registers(log, f"{tag}Lb{t}EE"),
                   *_frame_line(log, f"{tag}Lb{t}EE"))
            assert got == want[1 - t], tag


@pytest.mark.parametrize("parity", [False, True])
def test_shard_trace_equals_trace_wave(dev, parity):
    """shard_trace on the card repeated 8 times, (cam, px) = (2, 4): part
    k on mesh position k's device, the parts' concatenation bit-equal to
    trace_wave on the whole batch, 8 launches."""
    sc = (parity_scene if parity else flagship_scene)(64, 32, dev)
    ifrom, rays, seeds, sec = _frame_inputs(sc, 2, dev)
    mesh = mesh_for(2, 4, dev)
    counter = "LAUNCHES_PARITY" if parity else "LAUNCHES"
    before = getattr(tracer, counter)
    fbs, zbs = shard_trace(sc.tworld, sc.meta, sc.cfg, mesh, ifrom, rays,
                           seeds, sec)
    assert getattr(tracer, counter) == before + 8
    assert all(f.device == d for f, d in zip(fbs, mesh.flat))
    fb, zb = tracer.trace_wave(sc.tworld, sc.cfg, ifrom, rays, seeds, sec,
                               pack=True)
    assert torch.equal(torch.cat(fbs), fb)
    assert _bits_equal(torch.cat(zbs), zb)


@pytest.mark.parametrize("parity", [False, True])
def test_cave_frame_matches_plain(dev, parity):
    """The generated cave level (generate_maze(11), its smoothing on the
    card): the traced frame equals plain, and render_frame launches the
    tracer and the blur once."""
    sc = cave_scene(11, 160, 90, dev, parity=parity)
    ifrom, rays, seeds, sec = _frame_inputs(sc, 0, dev)
    fb_k, z_k = tracer.trace_wave(sc.tworld, sc.cfg, ifrom, rays, seeds, sec,
                                  pack=True)
    fb_p, z_p = tracer.trace_wave_plain(sc.tworld, sc.cfg, ifrom, rays,
                                        seeds, sec, True)
    assert torch.equal(fb_k, fb_p)
    assert _bits_equal(z_k, z_p)
    counter = "LAUNCHES_PARITY" if parity else "LAUNCHES"
    before = (getattr(tracer, counter), blur.LAUNCHES)
    fb, zbuf = render_frame(sc.tworld, sc.meta, sc.cfg, *sc.frame_args(0))
    assert (getattr(tracer, counter), blur.LAUNCHES) == (before[0] + 1,
                                                         before[1] + 1)
    assert int(torch.unique(fb).numel()) > 100


@pytest.mark.parametrize("parity", [False, True])
@pytest.mark.parametrize("w,h", [(1920, 1080), (320, 240), (203, 150),
                                 (1, 1)])
def test_ray_kernel_equals_plain(dev, w, h, parity):
    """frame_rays on the card, one launch of csrc/rays.cu's kernel, against
    the plain path on the CPU (gen_rays, pixel_seeds, the origin
    broadcast), all seven planes bit for bit, on three poses of the
    flagship camera path; 203 is a multiple of neither 32 nor 8."""
    sc = flagship_scene(w, h, "cpu")
    cfg = dataclasses.replace(sc.cfg, parity=parity)
    for k in (0, 3, 7):
        args = sc.frame_args(k)[:4]
        before = frame_mod.LAUNCHES_RAYS
        got = frame_rays(cfg, *args, dev)
        assert frame_mod.LAUNCHES_RAYS == before + 1
        want = frame_rays(cfg, *args, "cpu")
        for g, p in zip((*got[0], *got[1], got[2]),
                        (*want[0], *want[1], want[2])):
            assert g.device == dev and g.shape == (w * h,)
            assert torch.equal(g.cpu().view(torch.int32),
                               p.view(torch.int32)), k


@pytest.mark.parametrize("scene", ["flagship", "parity", "ptrace",
                                   "parity_ptrace", "maze"])
def test_frames_never_synchronise(dev, scene):
    """render_frame (fast, parity, the paged maze) and render_accumulated
    (samples 4, fast and parity) call no stream synchronisation once a
    frame of the shape has run (the first uploads the blur's tables):
    torch's sync debug mode "error" raises on one.  Each frame launches
    the ray kernel once and equals the tracer and the blur run on the
    plain path's rays; each maze frame launches the paged instance once
    and the one-page instance never."""
    sc = {"flagship": lambda: flagship_scene(128, 72, dev),
          "parity": lambda: parity_scene(128, 72, dev),
          "ptrace": lambda: ptrace_scene(128, 72, dev),
          "parity_ptrace": lambda: ptrace_scene(128, 72, dev,
                                                parity=True),
          "maze": lambda: maze_scene(128, 72, dev)}[scene]()

    def frame(k):
        if sc.cfg.samples > 1:
            return render_accumulated(sc.tworld, sc.meta, sc.cfg,
                                      *sc.frame_args(k),
                                      samples=sc.cfg.samples)
        return render_frame(sc.tworld, sc.meta, sc.cfg, *sc.frame_args(k))

    frame(0)
    torch.cuda.synchronize()
    before = frame_mod.LAUNCHES_RAYS
    paged = (tracer.LAUNCHES_PAGED, tracer.LAUNCHES)
    torch.cuda.set_sync_debug_mode("error")
    try:
        frames = [frame(k) for k in (1, 2, 3)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert frame_mod.LAUNCHES_RAYS == before + 3
    if scene == "maze":
        assert (tracer.LAUNCHES_PAGED, tracer.LAUNCHES) == (paged[0] + 3,
                                                            paged[1])
    for k, (fb, zb) in zip((1, 2, 3), frames):
        ifrom, rays, seeds, sec = _frame_inputs(sc, k, dev)
        fb_t, z_t = tracer.trace_wave(sc.tworld, sc.cfg, ifrom, rays, seeds,
                                      sec, pack=True, page0=sc.cfg.cam_page)
        z_t = z_t.view(72, 128)
        assert _bits_equal(zb, z_t)
        assert torch.equal(fb, blur.dof_blur(fb_t.view(72, 128), z_t))


@pytest.mark.parametrize("passes", [0, 1, 2])
@pytest.mark.parametrize("scene", ["flagship", "parity", "maze", "samples",
                                   "profile"])
def test_render_frame_route_equals_tensor_route(dev, scene, passes):
    """render_frame on the card launches the ray kernel, the tracer and
    each DoF pass by address on the rows of two blocks allocated once a
    frame: at every pass count, in both modes, on the paged maze, with
    samples 2 and with the profile knob (which allocates its step counts)
    it gives the bits of trace_wave and dof_blur run on frame_rays'
    tensors, with one launch of each kernel a pass; the framebuffer and
    the depth it returns are separate rows of one block."""
    kw = {"samples": dict(samples=2), "profile": dict(profile=True)}.get(
        scene, {})
    sc = {"parity": lambda: parity_scene(96, 40, dev, postproc_blur=passes),
          "maze": lambda: maze_scene(96, 40, dev, postproc_blur=passes)}.get(
        scene, lambda: flagship_scene(96, 40, dev, postproc_blur=passes,
                                      **kw))()
    args = sc.frame_args(3)
    ifrom, rays, seeds = frame_rays(sc.cfg, *args[:4], dev)
    fb_t, z_t = tracer.trace_wave(sc.tworld, sc.cfg, ifrom, rays, seeds,
                                  args[4], pack=True, page0=sc.cfg.cam_page)
    z_t = z_t.view(40, 96)
    want = blur.dof_blur(fb_t.view(40, 96), z_t, passes) if passes \
        else fb_t.view(40, 96)
    before = (frame_mod.LAUNCHES_RAYS, blur.LAUNCHES)
    fb, zb = render_frame(sc.tworld, sc.meta, sc.cfg, *args)
    assert (frame_mod.LAUNCHES_RAYS, blur.LAUNCHES) == (before[0] + 1,
                                                        before[1] + passes)
    assert fb.shape == zb.shape == (40, 96)
    assert (fb.dtype, zb.dtype) == (torch.int32, torch.float32)
    assert zb.data_ptr() - fb.data_ptr() == 4 * 40 * 96
    assert _bits_equal(zb, z_t)
    assert torch.equal(fb, want)
    assert torch.unique(fb).numel() > 50


# about 1 ms of the card's clock: torch.cuda._sleep holds the caller's
# stream so long that a frame on the render stream runs ahead of what
# the caller queued before or after it
HOLD_CYCLES = 2_000_000


def _want_frame(sc, k, dev):
    """frame k of sc by frame_rays_plain's tensors, trace_wave and
    dof_blur, all on the current stream: the int32 [h, w] framebuffer."""
    h, w = sc.cfg.height, sc.cfg.width
    args = sc.frame_args(k)
    ifrom, rays, seeds = frame_mod.frame_rays_plain(sc.cfg, *args[:4], dev)
    fb, z = tracer.trace_wave(sc.tworld, sc.cfg, ifrom, rays, seeds,
                              args[4], pack=True, page0=sc.cfg.cam_page)
    fb, z = fb.view(h, w), z.view(h, w)
    return blur.dof_blur(fb, z, sc.cfg.postproc_blur) \
        if sc.cfg.postproc_blur else fb


@pytest.mark.parametrize("passes", [0, 1])
def test_frames_delivered_through_pinned_buffers(dev, passes):
    """12 frames in the benchmark harness's loop: each framebuffer copied
    on the current stream, behind ~1 ms of other work there, to one of 2
    pinned host buffers, frame j's copy waited on before its buffer takes
    frame j + 2.  The render stream runs the next frames meanwhile; every
    delivered frame equals the plain rays' trace and blur, so no frame's
    output block went to a later frame while its copy was pending."""
    sc = flagship_scene(160, 96, dev, postproc_blur=passes)
    want = [_want_frame(sc, k, dev).cpu() for k in range(12)]
    bufs = [torch.empty((96, 160), dtype=torch.int32, pin_memory=True)
            for _ in range(2)]
    events = [torch.cuda.Event() for _ in range(2)]
    flight, got = [], {}

    def land():
        j, slot = flight.pop(0)
        events[slot].synchronize()
        got[j] = bufs[slot].clone()

    for k in range(12):
        fb, zb = render_frame(sc.tworld, sc.meta, sc.cfg, *sc.frame_args(k))
        if len(flight) == 2:
            land()
        torch.cuda._sleep(HOLD_CYCLES)
        bufs[k % 2].copy_(fb, non_blocking=True)
        events[k % 2].record()
        flight.append((k, k % 2))
        del fb, zb
    while flight:
        land()
    for k in range(12):
        assert torch.equal(got[k], want[k]), f"frame {k}"


def test_in_place_world_write_shows_in_the_next_frame(dev):
    """A world tensor written in place on the current stream, behind
    ~20 ms of other work there, between two frames of one camera: the
    render stream waits for the write (the world's version moved), so
    the second frame shows it and equals the edited world's frame."""
    from pwnfps_tpu_torch.ops.world import SCB, SCR

    sc = flagship_scene(160, 96, dev)
    args = sc.frame_args(3)
    fb0 = render_frame(sc.tworld, sc.meta, sc.cfg, *args)[0].clone()
    joins = frame_mod.STREAM_JOINS
    torch.cuda._sleep(20 * HOLD_CYCLES)
    sc.tworld.sph[:, SCB:SCR + 1].mul_(0.5)
    fb1 = render_frame(sc.tworld, sc.meta, sc.cfg, *args)[0]
    assert frame_mod.STREAM_JOINS == joins + 1
    assert not torch.equal(fb1, fb0)
    assert torch.equal(fb1, _want_frame(sc, 3, dev))


def test_stream_joins_once_a_world(dev):
    """12 frames of one world queue 12 frames on the render stream and
    join the caller's stream once, with one ray, tracer and blur launch
    a frame; a game session, which uploads a new world every tick, joins
    on every tick."""
    from pwnfps_tpu_torch.core.config import RenderConfig
    from pwnfps_tpu_torch.host.loop import GameSession

    sc = flagship_scene(64, 40, dev)
    before = (frame_mod.FRAMES_SIDE, frame_mod.STREAM_JOINS,
              frame_mod.LAUNCHES_RAYS, _counts())
    for k in range(12):
        render_frame(sc.tworld, sc.meta, sc.cfg, *sc.frame_args(k))
    torch.cuda.synchronize()
    assert (frame_mod.FRAMES_SIDE - before[0],
            frame_mod.STREAM_JOINS - before[1],
            frame_mod.LAUNCHES_RAYS - before[2]) == (12, 1, 12)
    assert _delta(before[3]) == (12, 0, 0, 0, 0, 12, 0, 0, 0)
    sess = GameSession(cfg=RenderConfig(width=64, height=40), device=dev)
    before = (frame_mod.FRAMES_SIDE, frame_mod.STREAM_JOINS)
    for _ in range(3):
        sess.render()
        sess.tick(1 / 60)
    assert (frame_mod.FRAMES_SIDE - before[0],
            frame_mod.STREAM_JOINS - before[1]) == (3, 3)
