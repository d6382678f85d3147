"""The frozen reference against the port's plain path, on the CPU.

The reference (portbench/reference/) is a copy of the port's plain torch
path taken at one commit; these tests hold it bit-equal to the port as
it stands, on tiny frames of both configurations, so that a change to
the port's plain semantics shows here before a chip run disagrees.

    python -m pytest portbench/tests -q
"""

from __future__ import annotations

import collections
import json
import os

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
W, H = 24, 16


def _config(name):
    with open(os.path.join(ROOT, "portbench", "configs",
                           f"{name}.json")) as f:
        return json.load(f)


def _view(config, **params):
    from portbench.traffic.view import View
    p = {"width": W, "height": H, "reflect": 2, "samples": 1,
         "postproc_blur": 1, "yaw_step": 0.07, "sec_step": 0.016,
         "start_frames": 4096, **params}
    return View(p, _config(config), ROOT, seed=977)


@pytest.mark.parametrize("config", ["demo-fast", "demo-parity"])
@pytest.mark.parametrize("samples", [1, 2])
def test_reference_frame_bit_equal_to_port(config, samples):
    """A whole frame, framebuffer after the DoF pass and depth, from the
    reference's own world equals the port's render_frame (or
    render_accumulated) on the CPU."""
    tr = _view(config, samples=samples)
    tr.setup("cpu")
    inputs = tr.inputs(3)
    fb, z = tr.issue(inputs)
    rw = tr.ref_world("cpu")
    (want_fb, want_z), = tr.reference(rw, [(inputs, torch.arange(W * H))])
    assert torch.equal(fb.reshape(-1), want_fb)
    assert torch.equal(z.reshape(-1).view(torch.int32),
                       want_z.view(torch.int32))


@pytest.mark.parametrize("config", ["demo-fast", "demo-parity"])
def test_sampled_pixels_equal_whole_frame(config):
    """Pixels traced alone, with the taps their DoF pass reads, and the
    pixels of two frames traced in one call, give each whole frame's
    values at those pixels."""
    tr = _view(config, width=48, height=32)
    rw = tr.ref_world("cpu")
    n = tr.width * tr.height
    rng = np.random.default_rng(5)
    frames = [(tr.inputs(k), torch.from_numpy(np.sort(rng.choice(
        n, 40, replace=False)))) for k in (11, 12)]
    got = tr.reference(rw, frames)
    for (inputs, idx), (fb, z) in zip(frames, got):
        (full_fb, full_z), = tr.reference(rw, [(inputs, torch.arange(n))])
        assert torch.equal(fb, full_fb[idx])
        assert torch.equal(z.view(torch.int32),
                           full_z[idx].view(torch.int32))


@pytest.mark.parametrize("config", ["demo-fast", "demo-parity"])
def test_work_counts_equal_port(config):
    """The reference's work counts of two frames are the sum of the
    port's plain tracer's counts of each (chip_smoke's roofline input)."""
    from pwnfps_tpu_torch.ops.tracer import trace_wave_plain
    from pwnfps_tpu_torch.render.frame import frame_rays
    tr = _view(config)
    tr.setup("cpu")
    want = collections.Counter()
    for k in (5, 6):
        inputs = tr.inputs(k)
        ifrom, rays, seeds = frame_rays(tr.cfg, *inputs[:4], "cpu")
        trace_wave_plain(tr.world, tr.cfg, ifrom, rays, seeds, inputs[4],
                         counts=want)
    got = tr.count(tr.ref_world("cpu"), [tr.inputs(5), tr.inputs(6)])
    assert got["counts"] == dict(want) and want["steps"] > 0
    assert got["parity"] == (config == "demo-parity")
    assert (got["frames"], got["rays"]) == (2, 2 * W * H)
