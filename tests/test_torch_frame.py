"""The port's `render_frame` (pwnfps_tpu_torch/render/frame.py) against the
JAX package's `render_frame` (backend jnp) on the flagship scene at
64x48: demo level, 14-sphere creature, three bounce waves, one DoF pass.

XLA:CPU contracts FMAs (see tests/fputil.py), so zbuf differs by ULPs
and, rarely, a blur tap lands one pixel over.  Limits from the measured
gap (fb 99.97% bit-exact, one pixel off by at most 6 per byte; zbuf 64%
bit-exact, within 3.9e-6 relative): fb at least 99.9% bit-exact, no
byte off by more than one blur tap's weight (64 of 255); zbuf within
1e-5 relative everywhere and at least half bit-exact.  Also: importing
the port never imports jax or the JAX package, and CPU tensors never
launch a kernel."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pwnfps_tpu.render.frame import render_frame as jax_render_frame
from pwnfps_tpu_torch.ops import blur, tracer
from pwnfps_tpu_torch.ops.world import world_to_torch
from pwnfps_tpu_torch.render import frame as frame_mod
from pwnfps_tpu_torch.render.frame import (fb_to_rgb, pixel_seeds,
                                           render_frame, upscale)
from pwnfps_tpu_torch.scene import flagship_scene

W, H = 64, 48
FRAME = 3           # a frame of the bench camera path


@pytest.fixture(scope="module")
def frames():
    sc = flagship_scene(W, H, "cpu")
    args = sc.frame_args(FRAME)
    before = (tracer.LAUNCHES, blur.LAUNCHES, frame_mod.LAUNCHES_RAYS)
    fb, zb = render_frame(sc.tworld, sc.meta, sc.cfg, *args)
    launches = (tracer.LAUNCHES - before[0], blur.LAUNCHES - before[1],
                frame_mod.LAUNCHES_RAYS - before[2])
    world = jax.tree.map(jnp.asarray, sc.world)
    jfb, jzb = jax_render_frame(world, sc.meta, sc.cfg,
                                *(jnp.asarray(a) for a in args[:4]),
                                args[4])
    return dict(fb=fb, zb=zb, jfb=np.asarray(jfb), jzb=np.asarray(jzb),
                launches=launches, scene=sc)


def test_frame_matches_jax_relaxed(frames):
    fb = frames["fb"].numpy().view(np.uint32)
    zb = frames["zb"].numpy()
    jfb, jzb = frames["jfb"], frames["jzb"]
    bt = fb.view(np.uint8).reshape(H, W, 4).astype(np.int32)
    bj = jfb.view(np.uint8).reshape(H, W, 4).astype(np.int32)
    fb_bit = np.mean(fb == jfb)
    z_bit = np.mean(zb.view(np.uint32) == jzb.view(np.uint32))
    db = np.abs(bt - bj).max()
    dz = np.abs(zb - jzb) / np.maximum(np.abs(jzb), 1e-3)
    msg = (f"fb {fb_bit:.5f} bit-exact, max byte diff {db}; zbuf "
           f"{z_bit:.3f} bit-exact, max rel diff {dz.max():.3g}")
    assert fb_bit >= 0.999 and db <= 64, msg
    assert dz.max() <= 1e-5 and z_bit >= 0.5, msg


def test_frame_outputs(frames):
    fb, zb = frames["fb"], frames["zb"]
    assert fb.shape == (H, W) and fb.dtype == torch.int32
    assert zb.shape == (H, W) and zb.dtype == torch.float32
    assert torch.isfinite(zb).all()
    assert torch.unique(fb).numel() > 100      # not a flat frame
    rgb = fb_to_rgb(fb.numpy().view(np.uint32))
    assert rgb.shape == (H, W, 3) and rgb.dtype == np.uint8
    assert upscale(rgb, 2).shape == (2 * H, 2 * W, 3)


def test_cpu_frame_launches_no_kernel(frames):
    assert frames["launches"] == (0, 0, 0)


def test_pixel_seeds_match_jax():
    from pwnfps_tpu.core import lcg as ref
    xs = np.arange(W, dtype=np.uint32)
    ys = np.arange(H, dtype=np.uint32)
    want = ref.pixel_seed(xs[None, :], ys[:, None], W).reshape(-1)
    got = pixel_seeds(W, H, "cpu").numpy().view(np.uint32)
    assert np.array_equal(got, want)


def test_unported_world_and_config_raise(frames):
    sc = frames["scene"]
    # a meta that claims two pages for a one-page word table
    with pytest.raises(ValueError):
        world_to_torch(sc.world, dataclasses.replace(sc.meta, n_pages=2),
                       "cpu")
    # parity mode ignores `fused`, as the JAX package does: the frame is
    # the parity frame
    small = dataclasses.replace(sc.cfg, parity=True, width=16, height=12)
    want = render_frame(sc.tworld, sc.meta, small, *sc.frame_args(0))
    got = render_frame(sc.tworld, sc.meta,
                       dataclasses.replace(small, fused=True),
                       *sc.frame_args(0))
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))


def test_port_never_imports_jax():
    """Importing every module of the port and chip_smoke.py, building the
    scenes, rendering a tiny frame of each single-frame path (fast,
    parity, the paged maze in both modes and fused, the multi-sample
    frame in both modes, the portal chain), a tiny camera batch, a frame
    sharded over a mesh and a camera step on a mesh, a frame and a tick
    of the game session, running the three tools, generating the cave
    level and a flat batch through `shard_trace` on the CPU imports
    neither jax nor any module of the JAX package pwnfps_tpu."""
    code = (
        "import contextlib, io, os, sys, pkgutil, importlib\n"
        "import pwnfps_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "from pwnfps_tpu_torch.parallel.sharding import (\n"
        "    render_cameras, render_frame_sharded)\n"
        "from pwnfps_tpu_torch.render.frame import (render_accumulated,\n"
        "                                           render_frame)\n"
        "from pwnfps_tpu_torch.scene import (flagship_scene, maze_scene,\n"
        "                                    mesh_for, multicam_scene,\n"
        "                                    parity_scene, ptrace_scene,\n"
        "                                    stress_scene)\n"
        "from pwnfps_tpu_torch.tools import launch_probe, vpu_probe\n"
        "import dataclasses\n"
        "for make in (flagship_scene, parity_scene, stress_scene,\n"
        "             maze_scene):\n"
        "    sc = make(8, 4, 'cpu', maxsteps=64)\n"
        "    render_frame(sc.tworld, sc.meta, sc.cfg, *sc.frame_args(1))\n"
        "for kw in ({'fused': True}, {'parity': True}):\n"
        "    render_frame(sc.tworld, sc.meta,\n"
        "                 dataclasses.replace(sc.cfg, **kw),\n"
        "                 *sc.frame_args(1))\n"
        "sc = ptrace_scene(8, 4, 'cpu', maxsteps=64)\n"
        "render_accumulated(sc.tworld, sc.meta, sc.cfg, *sc.frame_args(1),\n"
        "                   samples=sc.cfg.samples)\n"
        "sc = ptrace_scene(8, 4, 'cpu', parity=True, maxsteps=64)\n"
        "render_accumulated(sc.tworld, sc.meta, sc.cfg, *sc.frame_args(1),\n"
        "                   samples=2)\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        "    launch_probe.main(['--device', 'cpu', '--ns', '1', '2',\n"
        "                       '--reps', '1', '--tiles', '1', '--rows', '8'])\n"
        "    vpu_probe.main(['--device', 'cpu', '--T', '1'])\n"
        "sc = multicam_scene('cpu', n_cams=2, width=8, height=4,\n"
        "                    maxsteps=64, postproc_blur=1)\n"
        "render_cameras(sc.tworld, sc.meta, sc.cfg, *sc.step_args(1))\n"
        "render_cameras(sc.tworld, sc.meta, sc.cfg, *sc.step_args(1),\n"
        "               mesh_for(2, 1, 'cpu'))\n"
        "sc = flagship_scene(8, 16, 'cpu', maxsteps=64)\n"
        "render_frame_sharded(sc.world, sc.meta, sc.cfg, *sc.frame_args(1),\n"
        "                     mesh_for(1, 2, 'cpu'))\n"
        "from pwnfps_tpu_torch.core.config import RenderConfig\n"
        "from pwnfps_tpu_torch.host.loop import GameSession\n"
        "from pwnfps_tpu_torch.host.physics import Keys\n"
        "from pwnfps_tpu_torch.tools import occupancy\n"
        "sess = GameSession(cfg=RenderConfig(width=8, height=4, maxsteps=64),\n"
        "                   device='cpu')\n"
        "sess.render()\n"
        "sess.tick(1 / 60, Keys(forward=True))\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        "    occupancy.main(['maze', '--device', 'cpu', '--width', '8',\n"
        "                    '--height', '4', '--out', os.devnull])\n"
        "from pwnfps_tpu_torch.world.procgen import generate_maze\n"
        "generate_maze(11, device='cpu')\n"
        "from pwnfps_tpu_torch.ops.vec import V3\n"
        "from pwnfps_tpu_torch.parallel.sharding import shard_trace\n"
        "import torch\n"
        "sc = flagship_scene(8, 2, 'cpu', maxsteps=64)\n"
        "ones = V3(*(torch.full((16,), 0.5) for _ in range(3)))\n"
        "shard_trace(sc.world, sc.meta, sc.cfg, mesh_for(2, 1, 'cpu'),\n"
        "            ones, ones, torch.zeros(16, dtype=torch.int32), 0.0)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'pwnfps_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
