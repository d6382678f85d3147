"""The correctness check fails what it must fail.

On the CPU, at a size a test run holds: a whole run of each cell
(set-up, window, check) with the program as it is comes out correct;
with the timed path broken underneath in each way a view cell can break
it comes out not correct; and with each configuration's control (a lower
precision, see portbench/control.py) in the program's place it comes out
not correct.  The faults: a step that returns the state it had (the
previous step's frame), half of the frame's rows left out, and one
pixel altered where the tracer produces it.  An exchange between chips
has no place in a one-chip cell.

On the card (marker `cuda`; skips without one), the control at each
cell's own size on three seeds:

    python -m pytest portbench/tests/test_portbench_control.py -m cuda -s
"""

from __future__ import annotations

import os

import pytest
import torch

from portbench import control, harness
from portbench.traffic.view import View

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELLS = ["flagship-1080p", "parity-1080p", "ptrace-1080p",
         "parity-ptrace-1080p"]
TINY = dict(width=32, height=24, warmup_steps=1, check_frames=2,
            check_pixels=0)


def _run(cell, issue=None, seed=2 ** 31 + 7):
    return harness.run_cell(cell, seed, 0.0, False, device="cpu",
                            root=ROOT, overrides=TINY, issue=issue,
                            min_steps=4, log=lambda *a, **k: None)


def _stale():
    """Each step delivers the frame of the step before it."""
    last = {}

    def issue(tr, inputs):
        out = View.issue(tr, inputs)
        prev = last.get("out", out)
        last["out"] = out
        return prev
    return issue


def _half(tr, inputs):
    """The lower half of the frame's rows is never traced."""
    fb, z = View.issue(tr, inputs)
    fb, z = fb.clone(), z.clone()
    fb[tr.height // 2:] = 0
    z[tr.height // 2:] = 1.0
    return fb, z


def _altered(tr, inputs):
    """One pixel's colour is off by one in its lowest byte."""
    fb, z = View.issue(tr, inputs)
    fb = fb.clone()
    fb[tr.height // 3, tr.width // 3] ^= 1
    return fb, z


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    r = _run(cell)
    assert r["correct"] and r["failed"] == 0
    assert r["checks"]["fb_px_off"]["value"] == 0
    assert r["checks"]["frames_checked"]["value"] == 2


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
@pytest.mark.parametrize("cell", ["flagship-1080p", "parity-ptrace-1080p"])
def test_fault_is_not_correct(cell, fault):
    issue = {"stale": _stale(), "half": _half, "altered": _altered}[fault]
    r = _run(cell, issue)
    assert not r["correct"]
    assert r["checks"]["frames_checked"]["value"] == 2
    assert r["checks"]["fb_px_off"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    r = control.run(cell, 2 ** 31 + 11, device="cpu", overrides=TINY,
                    log=lambda *a, **k: None)
    assert not r["correct"]
    assert r["checks"]["frames_checked"]["value"] == 2
    assert (r["checks"]["fb_px_off"]["value"]
            + r["checks"]["zbuf_px_off"]["value"]) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for seed in (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303):
        r = control.run(cell, seed, device="cuda")
        print(cell, seed, r["checks"])
        assert not r["correct"]
        assert r["checks"]["frames_checked"]["value"] >= 2
