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
versions."""

import numpy as np
import pytest
import torch

from pwnfps_tpu_torch.ops import blur, probes, tracer
from pwnfps_tpu_torch.ops.vec import V3
from pwnfps_tpu_torch.parallel.sharding import (_halo, camera_rays,
                                                render_cameras,
                                                render_frame_sharded)
from pwnfps_tpu_torch.render.frame import (gen_rays, pixel_seeds,
                                           render_accumulated, render_frame)
from pwnfps_tpu_torch.scene import (flagship_scene, maze_scene, mesh_for,
                                    multicam_scene, parity_scene,
                                    portal_camera, ptrace_scene,
                                    stress_scene)
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
            blur.LAUNCHES, blur.LAUNCHES_FRAMES)


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
    assert _delta(before) == (0, 0, 1, 0, 0, 0, 0)
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
    assert _delta(before) == (0, 0, 1, 0, 0, 1, 0)
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
    assert _delta(before) == (0, 0, 0, 0, 0, 2, 2)
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
    assert _delta(before) == (1, 0, 0, 0, 0, passes, passes)
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
    with pytest.raises(NotImplementedError):          # unpacked colour
        tracer.trace_wave(sc.tworld, sc.cfg, rays, rays, seeds, 0.0)


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
    and 8 band blur launches a frame either way, no frame blur."""
    sc = flagship_scene(96, h, dev)
    args = sc.frame_args(2)
    before = (_counts(), blur.LAUNCHES_BAND)
    fb, zb = render_frame_sharded(sc.tworld, sc.meta, sc.cfg, *args,
                                  mesh_for(2, 4, dev))
    torch.cuda.synchronize()
    assert (_delta(before[0]), blur.LAUNCHES_BAND - before[1]) == (
        (8, 0, 0, 0, 0, 0, 0), 8)
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
        (8, 0, 0, 0, 0, 0, 0), 8)
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
    assert _delta(before) == (0, 0, 0, 0, 1, 0, 0)
    fb_p, z_p = tracer.trace_wave_plain(sc.tworld, sc.cfg, ifrom, rays,
                                        seeds, sec, pack=True)
    assert torch.equal(fb_k, fb_p)
    assert torch.equal(z_k.view(torch.int32), z_p.view(torch.int32))
    before = _counts()
    fb, zb = render_accumulated(sc.tworld, sc.meta, sc.cfg,
                                *sc.frame_args(1), samples=samples)
    torch.cuda.synchronize()
    assert _delta(before) == (0, 0, 0, 0, 1, 1, 0)
    assert torch.equal(zb.view(torch.int32), z_k.view(torch.int32).reshape(
        48, 64))
    assert torch.equal(fb, blur.dof_blur_plain(fb_k.reshape(48, 64), zb))


def test_stress_kernel_matches_plain(dev):
    sc = stress_scene(160, 90, dev)
    ifrom, rays, seeds, sec = _frame_inputs(sc, 0, dev)
    before = _counts()
    fb_k, z_k = tracer.trace_wave(sc.tworld, sc.cfg, ifrom, rays, seeds,
                                  sec, pack=True)
    assert _delta(before) == (1, 0, 0, 0, 0, 0, 0)
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
