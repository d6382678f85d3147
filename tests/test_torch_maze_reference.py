"""The port's sector maze (BASELINE config #3) against the benchmark's
plain reference, on the CPU.

The benchmark's cell `maze-720p` builds its world through the program
(`portbench/worlds/sector_maze.py`: the port's `generate_sector_maze`,
`build_world_paged` and `world_to_torch`) and checks it against a world
that the reference builds alone (`portbench/reference/worlds/
sector_maze.py`, from its own copy of the generator).  These tests hold
the two bit-equal at small sizes, so that a change to the port's maze or
its paged path shows here before a chip run disagrees: the generator's
words and info, whole frames (framebuffer after the DoF pass, and depth)
on the cell's camera path and on a camera facing a cross-page portal,
the plain tracer's work counts that the tracer's roofline reads, and the
refusal of a camera page the maze does not spawn on.
"""

from __future__ import annotations

import collections
import json
import os

import numpy as np
import pytest
import torch

from portbench.reference.world.procgen import \
    generate_sector_maze as ref_maze
from portbench.reference.worlds import sector_maze as ref_world
from portbench.traffic.view import View
from portbench.worlds import sector_maze as prog_world
from pwnfps_tpu_torch.ops.tracer import trace_wave_plain
from pwnfps_tpu_torch.render.frame import frame_rays
from pwnfps_tpu_torch.scene import maze_scene
from pwnfps_tpu_torch.world.procgen import generate_sector_maze

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config(**over):
    with open(os.path.join(ROOT, "portbench", "configs",
                           "sector-maze.json")) as f:
        return {**json.load(f), **over}


def _view(w, h):
    """The cell's traffic at w x h, on the CPU, its path from frame 0."""
    with open(os.path.join(ROOT, "portbench", "traffic",
                           "view-config3-720p.json")) as f:
        params = {**json.load(f), "width": w, "height": h}
    tr = View(params, _config(), ROOT, seed=0)
    tr.setup("cpu")
    return tr


def _same_frame(tr, rw, inputs):
    fb, z = tr.issue(inputs)
    (want_fb, want_z), = tr.reference(
        rw, [(inputs, torch.arange(tr.width * tr.height))])
    assert torch.equal(fb.reshape(-1), want_fb)
    assert torch.equal(z.reshape(-1).view(torch.int32),
                       want_z.view(torch.int32))


@pytest.mark.parametrize("pages", [4, 2])
@pytest.mark.parametrize("seed", [7, 0, 3])
def test_reference_generator_equals_port(seed, pages):
    """The reference's copy of the generator gives the port's words and
    info: sectors, portal pairs, spawn and the sector centres."""
    words, info = generate_sector_maze(seed=seed, pages=pages)
    rwords, rinfo = ref_maze(seed=seed, pages=pages)
    assert words.dtype == rwords.dtype and np.array_equal(words, rwords)
    for k in ("sectors", "portal_pairs", "spawn"):
        assert info[k] == rinfo[k], k
    assert info["sectors"] == pages * 256
    for p, i, j in ((0, 0, 0), (pages - 1, 15, 3), (1, 7, 9)):
        assert info["sector_centre"](p, i, j) == \
            rinfo["sector_centre"](p, i, j)


@pytest.mark.parametrize("w,h", [(64, 36), (48, 27)])
def test_path_frames_equal_reference(w, h):
    """render_frame on the program's world gives the reference's frame,
    fb and zbuf bit for bit, on frames 0 and 5 of the cell's path."""
    tr = _view(w, h)
    rw = tr.ref_world("cpu")
    assert rw.meta.n_pages == tr.meta.n_pages == 4
    for k in (0, 5):
        _same_frame(tr, rw, tr.inputs(k))


def test_portal_frame_equals_reference():
    """The same on the camera of scene.portal_camera, which faces a
    cross-page portal: most primary rays change page there."""
    tr = _view(64, 36)
    tr.cam0 = maze_scene(64, 36, "cpu", view="portal").cam
    _same_frame(tr, tr.ref_world("cpu"), tr.inputs(0))


def test_work_counts_equal_port():
    """The reference's work counts of a whole portal-camera frame, which
    the tracer's roofline reads, equal the port's plain tracer's; most of
    that frame's primary segments end off the camera's page."""
    tr = _view(64, 36)
    tr.cam0 = maze_scene(64, 36, "cpu", view="portal").cam
    inputs = tr.inputs(0)
    want = tr.count(tr.ref_world("cpu"), [inputs])
    ifrom, rays, seeds = frame_rays(tr.cfg, *inputs[:4], "cpu")
    got, segs = collections.Counter(), []
    trace_wave_plain(tr.world, tr.cfg, ifrom, rays, seeds, inputs[4],
                     counts=got, page0=tr.cfg.cam_page, segs=segs)
    assert want["counts"] == dict(got)
    off_page = (segs[0].tpage != tr.cfg.cam_page).double().mean()
    assert off_page > 0.5, float(off_page)
    assert got["steps"] > 0 and got["segments"] >= 64 * 36
    assert want["rays"] == 64 * 36 and not want["parity"]


@pytest.mark.parametrize("module", ["program", "reference"])
def test_world_refuses_another_cam_page(module):
    """Every primary ray of the view traffic starts on page 0: a
    configuration whose cam_page is not the maze's spawn page is refused
    by both world modules, and the reference's camera with it."""
    config = _config(cam_page=1)
    mod = prog_world if module == "program" else ref_world
    with pytest.raises(ValueError, match="cam_page"):
        mod.build(config, ROOT, "cpu")
    if module == "reference":
        with pytest.raises(ValueError, match="cam_page"):
            ref_world.camera(config, ROOT)
