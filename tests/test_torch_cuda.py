"""The CUDA kernels of the port against their plain torch versions, on
the card.  Skipped where torch sees no CUDA device.

The repository's tests/conftest.py imports jax, which the card's machine
need not have, so run these there with:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Small versions of chip_smoke.py's phases 3-7: the blur kernel equals the
plain pass bit for bit; the tracer kernel equals the plain tracer bit
for bit in fb and zbuf (the same device math functions, no FMA
contraction on either side), in fast mode and in parity mode, where it
also equals the plain parity tracer run on the host's CPU; render_frame
launches each kernel once per frame."""

import numpy as np
import pytest
import torch

from pwnfps_tpu_torch.ops import blur, tracer
from pwnfps_tpu_torch.ops.vec import V3
from pwnfps_tpu_torch.render.frame import gen_rays, pixel_seeds, render_frame
from pwnfps_tpu_torch.scene import flagship_scene, parity_scene

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
