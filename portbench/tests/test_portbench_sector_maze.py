"""The cell maze-720p (configuration sector-maze, world kind sector_maze)
on the CPU, at 32x24: a whole run with the program as it is comes out
correct; the faults of test_portbench_control (the previous step's frame,
half of the rows left out, one pixel altered) and the configuration's
control (ray directions in bfloat16) come out not correct; and the
reference, with the world kind's modules, loads nothing of the program.

On the card (marker `cuda`; skips without one), the control at the
cell's own size on three seeds:

    python -m pytest portbench/tests/test_portbench_sector_maze.py -m cuda -s
"""

from __future__ import annotations

import pytest
import torch

from portbench import control, harness
from test_portbench_control import TINY, _altered, _half, _run, _stale
from test_portbench_imports import REFERENCE, _loaded_after

CELL = "maze-720p"
MAZE = ["portbench.reference.world.procgen",
        "portbench.reference.worlds.sector_maze"]


def test_sound_run_is_correct():
    r = _run(CELL)
    assert r["correct"] and r["failed"] == 0
    assert r["checks"]["fb_px_off"]["value"] == 0
    assert r["checks"]["zbuf_px_off"]["value"] == 0
    assert r["checks"]["frames_checked"]["value"] == 2


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
def test_fault_is_not_correct(fault):
    issue = {"stale": _stale(), "half": _half, "altered": _altered}[fault]
    r = _run(CELL, issue)
    assert not r["correct"]
    assert r["checks"]["frames_checked"]["value"] == 2
    assert r["checks"]["fb_px_off"]["value"] > 0


def test_control_is_not_correct():
    r = control.run(CELL, 2 ** 31 + 11, device="cpu", overrides=TINY,
                    log=lambda *a, **k: None)
    assert not r["correct"]
    assert r["checks"]["frames_checked"]["value"] == 2
    assert (r["checks"]["fb_px_off"]["value"]
            + r["checks"]["zbuf_px_off"]["value"]) > 0


def test_reference_loads_nothing_of_the_program():
    """The reference with the maze's generator and world module, in a
    fresh interpreter: no pwnfps_tpu_torch, pwnfps_tpu or jax module."""
    loaded = _loaded_after("\n".join(f"import {m}"
                                     for m in REFERENCE + MAZE))
    assert not loaded & {"pwnfps_tpu_torch", *harness.FORBIDDEN}


def test_cell_run_loads_no_jax():
    """A run of the cell, the program's maze built and rendered: the
    program is loaded, jax and the JAX package are not."""
    loaded = _loaded_after(
        "import portbench.harness as h\n"
        f"h.run_cell({CELL!r}, 5, 0.0, False, device='cpu', root='.', "
        "overrides=dict(width=16, height=8, warmup_steps=1), "
        "min_steps=2, log=lambda *a, **k: None)")
    assert "pwnfps_tpu_torch" in loaded
    assert not loaded & set(harness.FORBIDDEN)


@pytest.mark.cuda
def test_control_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for seed in (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303):
        r = control.run(CELL, seed, device="cuda")
        print(CELL, seed, r["checks"])
        assert not r["correct"]
        assert r["checks"]["frames_checked"]["value"] >= 2
