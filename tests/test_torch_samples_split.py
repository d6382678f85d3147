"""A multi-sample trace splits into one-sample traces, which is what the
samples statistic of pwnfps_tpu_torch/tools/occupancy.py reads.

  * On config #5's scene (`ptrace_scene`, reflect 6, samples 4) at
    32x18, the four samples = 1 traces on the seeds seed + k*0x9E3779B9
    (`occupancy.sample_seeds`), unpacked, summed in sample order and
    scaled by f32(1/4), pack to the samples = 4 trace's fb bit for bit,
    and sample 0's distance is its zbuf; the profile instance's primary
    wave is the same on sample 0's and sample 1's seeds, its bounce
    waves are not.
  * `occupancy.samples_stats` on a hand-made tstep whose step slots are
    counted by hand, one full 8x4 warp and one ragged one.

Plain torch tracer only, no JAX."""

import dataclasses

import numpy as np
import torch

from pwnfps_tpu_torch.ops import tracer
from pwnfps_tpu_torch.ops.tracer_core import col_ftoint
from pwnfps_tpu_torch.render.frame import frame_rays
from pwnfps_tpu_torch.scene import ptrace_scene
from pwnfps_tpu_torch.tools import occupancy


def test_samples_equal_one_sample_traces_on_weyl_seeds():
    sc = ptrace_scene(32, 18, "cpu")
    assert (sc.cfg.reflect, sc.cfg.samples) == (6, 4)
    origin, rayb, rdx, rdy, sec = sc.frame_args(0)
    ifrom, rays, seeds = frame_rays(sc.cfg, origin, rayb, rdx, rdy, "cpu")
    fb, z = tracer.trace_wave(sc.tworld, sc.cfg, ifrom, rays, seeds, sec,
                              pack=True)
    one = dataclasses.replace(sc.cfg, samples=1)
    for k in range(sc.cfg.samples):
        col, dist = tracer.trace_wave(sc.tworld, one, ifrom, rays,
                                      occupancy.sample_seeds(seeds, k), sec)
        acc, dist0 = (col, dist) if k == 0 else (acc + col, dist0)
    mean = acc * float(np.float32(1.0 / sc.cfg.samples))
    assert torch.equal(col_ftoint(mean), fb)
    assert torch.equal(dist0.view(torch.int32), z.view(torch.int32))
    # the primary wave draws no random number: its step counts are the
    # same on every sample's seeds, which samples_stats requires
    sc1 = occupancy.scene("ptrace", 32, 18, "cpu")
    ts = np.stack([occupancy.profile(sc1, "cpu", k)[2].numpy()
                   for k in range(2)])
    assert (ts[:, 0] == ts[0, 0]).all() and (ts[:, 1] != ts[0, 1]).any()
    occupancy.samples_stats(ts, sc.cfg.height, sc.cfg.width)
    # the chains differ: sample 1's seeds are not sample 0's
    assert not torch.equal(occupancy.sample_seeds(seeds, 1), seeds)
    assert torch.equal(occupancy.sample_seeds(seeds, 0), seeds)


def test_sample_seeds_wrap_as_uint32():
    seeds = torch.tensor([0, -1, 2 ** 31 - 1, -(2 ** 31)], dtype=torch.int32)
    for k in range(4):
        want = (seeds.numpy().view(np.uint32)
                + np.uint32(k * 0x9E3779B9 & 0xFFFFFFFF)).view(np.int32)
        assert occupancy.sample_seeds(seeds, k).numpy().tolist() \
            == want.tolist()


def test_samples_stats_on_a_hand_made_tstep():
    # a 12x4 image: warp 0 the 8x4 tile of columns 0-7 (32 lanes), warp 1
    # the ragged tile of columns 8-11 (16 lanes); 2 samples, 2 waves
    h, w = 4, 12
    t = np.zeros((2, 2, h * w), np.int64)
    x = np.arange(h * w) % w
    t[:, 0, x < 8] = 1
    t[:, 0, 0] = 2                     # pixel (0, 0): warp 0, lane 0
    t[:, 0, x >= 8] = 3
    t[0, 1, 0] = 5                     # sample 0's bounce: lane 0 only
    t[1, 1, 1] = 5                     # sample 1's bounce: lane 1 only
    st = occupancy.samples_stats(t, h, w)
    # warp 0 today: 2 + 5 + 5 slots a lane; with refill lane 0's 2 + 5
    # (lane 1: 1 + 5); warp 1: its 3 primary steps either way
    assert st["steps_today"] == 32 * 12 + 16 * 3
    assert st["steps_refill"] == 32 * 7 + 16 * 3
    assert st["needed"] == 2 + 31 + 5 + 5 + 16 * 3
    assert st["refill_gain"] == (32 * 12 + 16 * 3) / (32 * 7 + 16 * 3)
    assert st["occupancy_today"] == st["needed"] / st["steps_today"]
    assert st["samples"] == 2
    # segments: warp 0 shades wave 0 and each sample's bounce wave (3
    # passes) today; with refill its lanes 0 and 1 have 2 segments each
    # (wave 0 and one bounce), so 2 passes; warp 1 one pass either way
    assert st["segments_today"] == 32 * 3 + 16
    assert st["segments_refill"] == 32 * 2 + 16
    assert st["segments_needed"] == 32 + 2 + 16
    t[1, 0, 0] = 3                     # primary waves that differ
    try:
        occupancy.samples_stats(t, h, w)
    except ValueError:
        pass
    else:
        raise AssertionError("primary waves that differ were accepted")
