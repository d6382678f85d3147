"""The fused wave loop (`RenderConfig.fused`, tracer_core.run_fused) in
the port, on the CPU.

The fused loop shades a lane that terminates and restarts it on its
bounce ray inside one DDA loop; each lane's march is the unfused one, and
the unwind blend becomes a forward affine that associates the reflectance
products differently.  So, as tests/test_fused.py holds the JAX package's
two loops to each other:

  * on the fuzz scene of tests/test_space_skip.py (portals, ramps, fog,
    a 2-high room, six spheres), 256 rays at reflect 1, 2 and 3: the
    port's fused trace has dist bit-equal to its unfused trace and
    colours within rtol = atol = 3e-6 of it;
  * the same two checks on a 48x27 frame of the paged maze (BASELINE
    config #3) in fast mode from a camera facing a cross-page portal;
  * a 32x24 fused frame of `stress_scene` (BASELINE config #2, frame 0,
    blur off, the camera 0.13/0.07 off the cell centre as in
    tests/test_torch_stress.py) against JAX `render_frame(fused=True,
    backend="jnp")`, within tests/test_torch_frame.py's frame limits;
  * parity mode ignores `fused`, as the JAX package does: the 32x24
    parity frame with fused=True equals the scalar spec's frame of
    tests/test_torch_parity.py bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pwnfps_tpu.render.frame import render_frame as jax_render_frame
from pwnfps_tpu_torch.core.approx import SseTables
from pwnfps_tpu_torch.core.config import RenderConfig
from pwnfps_tpu_torch.ops import tracer
from pwnfps_tpu_torch.ops import worlddev as W
from pwnfps_tpu_torch.ops.vec import V3
from pwnfps_tpu_torch.ops.world import world_to_torch
from pwnfps_tpu_torch.render.frame import gen_rays, pixel_seeds, render_frame
from pwnfps_tpu_torch.scene import maze_scene, portal_camera, stress_scene
from pwnfps_tpu_torch.world.levelc import compile_level
from pwnfps_tpu_torch.world.objects import ObjectPool

from .test_space_skip import FUZZ_LEVEL, FUZZ_SPHERES, _fuzz_rays
from .test_torch_parity import _bits, frame_pair  # noqa: F401 (fixture)
from .test_torch_samples import _torch_rays

SEC = np.float32(0.7)


def _launches():
    return (tracer.LAUNCHES, tracer.LAUNCHES_PAGED, tracer.LAUNCHES_FUSED)


def _both(wt, cfg, ifrom, iray, seeds, page0=0):
    """(unfused, fused) traces of the same rays: colours [n, 4] and
    distances, on the plain tracer (no launch on the CPU)."""
    before = _launches()
    out = []
    for fused in (False, True):
        col, dist = tracer.trace_wave(
            wt, dataclasses.replace(cfg, fused=fused), ifrom, iray, seeds,
            SEC, page0=page0)
        out.append((np.stack([c.numpy() for c in col], 1), dist.numpy()))
    assert _launches() == before
    return out


def _assert_close(unfused, fused):
    (cu, du), (cf, df) = unfused, fused
    assert np.isfinite(cf).all() and np.isfinite(df).all()
    assert np.array_equal(_bits(df), _bits(du)), \
        f"{(_bits(df) != _bits(du)).sum()} distances differ"
    np.testing.assert_allclose(cf, cu, rtol=3e-6, atol=3e-6)


@pytest.fixture(scope="module")
def fuzz_world():
    pool = ObjectPool()
    for (x, y, z, r) in FUZZ_SPHERES:
        i = pool.obj_new()
        pool.obj_set_sphere(i, r, 0.4, x, y, z, 0.8, 0.7, 0.9)
    world, meta = W.build_world(compile_level(FUZZ_LEVEL),
                                pool.prepare_render(), SseTables.load())
    return world_to_torch(world, meta, "cpu")


@pytest.mark.parametrize("reflect", [1, 2, 3])
def test_fused_matches_unfused_on_fuzz_scene(fuzz_world, reflect):
    fv, rv = _fuzz_rays(n=256, seed0=3)
    froms = np.stack([np.asarray(c) for c in fv], 1)
    dirs = np.stack([np.asarray(c) for c in rv], 1)
    seeds = np.random.default_rng(1).integers(0, 2 ** 31, 256).astype(
        np.uint32)
    cfg = RenderConfig(parity=False, maxsteps=200, reflect=reflect)
    unfused, fused = _both(fuzz_world, cfg,
                           *_torch_rays(froms, dirs, seeds))
    _assert_close(unfused, fused)


def test_fused_matches_unfused_on_paged_maze():
    sc = maze_scene(48, 27, "cpu")
    sc.cam = portal_camera(sc)
    origin, rayb, rdx, rdy, _ = sc.frame_args(0)
    n = 48 * 27
    rays = gen_rays(*(torch.from_numpy(v) for v in (rayb, rdx, rdy)), 48,
                    27)
    ifrom = V3(*(torch.full((n,), float(origin[i])) for i in range(3)))
    unfused, fused = _both(sc.tworld, sc.cfg, ifrom, rays,
                           pixel_seeds(48, 27, "cpu"), sc.cfg.cam_page)
    _assert_close(unfused, fused)


def test_fused_stress_frame_matches_jax():
    sc = stress_scene(32, 24, "cpu", postproc_blur=0, fused=True)
    sc.cam[3, 0] += 0.13
    sc.cam[3, 2] += 0.07
    args = sc.frame_args(0)
    before = _launches()
    fb, zb = render_frame(sc.tworld, sc.meta, sc.cfg, *args)
    assert _launches() == before                 # CPU: the plain loop
    jfb, jzb = jax_render_frame(jax.tree.map(jnp.asarray, sc.world),
                                sc.meta, sc.cfg,
                                *(jnp.asarray(a) for a in args[:4]), args[4])
    fb, zb = fb.numpy().view(np.uint32), zb.numpy()
    jfb, jzb = np.asarray(jfb), np.asarray(jzb)
    bt = fb.view(np.uint8).astype(np.int32)
    bj = jfb.view(np.uint8).astype(np.int32)
    fb_bit = np.mean(fb == jfb)
    db = np.abs(bt - bj).max()
    dz = np.abs(zb - jzb) / np.maximum(np.abs(jzb), 1e-3)
    msg = (f"fb {fb_bit:.5f} bit-exact, max byte diff {db}; zbuf max rel "
           f"diff {dz.max():.3g}")
    assert fb.shape == (24, 32)
    assert fb_bit >= 0.999 and db <= 64, msg
    assert dz.max() <= 1e-5, msg
    assert np.isfinite(zb).all() and len(np.unique(fb)) > 50, msg


def test_parity_ignores_fused(frame_pair):  # noqa: F811
    cfg = dataclasses.replace(frame_pair["sc"].cfg, fused=True)
    before = (tracer.LAUNCHES_PARITY, tracer.LAUNCHES_FUSED)
    fb, zb = render_frame(frame_pair["sc"].tworld, frame_pair["sc"].meta,
                          cfg, *frame_pair["args"])
    assert (tracer.LAUNCHES_PARITY, tracer.LAUNCHES_FUSED) == before
    assert np.array_equal(fb.numpy().view(np.uint32), frame_pair["ref_fb"])
    assert np.array_equal(_bits(zb.numpy()), _bits(frame_pair["ref_zb"]))
