"""The port's plain tracer (pwnfps_tpu_torch/ops/tracer.py) against the
JAX package's jnp backend (pwnfps_tpu/ops/tracer_jnp.py:trace_wave),
fast mode, on 64 random rays over the demo level with a 3-sphere scene,
with the empty-space skip on and off.

XLA:CPU contracts mul+add into FMAs and uses other sin/cos/exp/rsqrt
than eager torch, so the two agree to ULPs rather than bit for bit.
Limits from the measured gap (56% of rays bit-exact, colour within
2.3e-5, distance within 1.5e-7 relative): every ray's colour within
1e-4 and distance within 1e-5 relative, and at least a quarter of the
rays bit-exact.  The measured shares are in the message."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pwnfps_tpu.ops.tracer_jnp import trace_wave as jax_trace_wave
from pwnfps_tpu.ops.vec import V3 as JV3
from pwnfps_tpu_torch.ops import tracer
from pwnfps_tpu_torch.ops.tracer_core import col_ftoint, to_i32
from pwnfps_tpu_torch.ops.vec import V3
from pwnfps_tpu_torch.render.frame import render_frame
from pwnfps_tpu_torch.scene import flagship_scene, maze_scene

N = 64
SEC = np.float32(2.5)
# start cells of the demo level (tests/test_tracer_scalar.py:96-97)
BASES = [(3.5, 0.5, 3.5), (13.5, 0.5, 3.5), (18.5, 0.5, 5.5),
         (2.5, 0.5, 9.5), (7.5, 0.5, 12.5), (13.5, 0.5, 13.5)]


def _rays(n, seed0=11):
    """Random origins near BASES and directions flattened in y, built as
    tests/test_pallas.py:32-49 builds them."""
    rng = np.random.default_rng(seed0)
    froms = np.zeros((n, 3), np.float32)
    dirs = np.zeros((n, 3), np.float32)
    for k in range(n):
        b = BASES[k % len(BASES)]
        froms[k] = [b[0] + rng.uniform(-0.4, 0.4),
                    b[1] + rng.uniform(-0.1, 0.4),
                    b[2] + rng.uniform(-0.4, 0.4)]
        d = rng.normal(size=3)
        d /= np.linalg.norm(d)
        dirs[k] = [d[0], d[1] * 0.6, d[2]]
    seeds = rng.integers(0, 2 ** 31, n).astype(np.uint32)
    return froms, dirs, seeds


@pytest.fixture(scope="module", params=[True, False],
                ids=["skip", "noskip"])
def traced(request):
    """Both sides traced once per setting of cfg.space_skip (the
    empty-space skip changes which steps a ray takes)."""
    sc = flagship_scene(32, 2, "cpu", n_spheres=3, maxsteps=1000,
                        space_skip=request.param)
    froms, dirs, seeds = _rays(N)
    world = jax.tree.map(jnp.asarray, sc.world)
    colj, distj = jax_trace_wave(
        world, sc.meta, sc.cfg, JV3(*(jnp.asarray(froms[:, i])
                                      for i in range(3))),
        JV3(*(jnp.asarray(dirs[:, i]) for i in range(3))),
        jnp.asarray(seeds), SEC)
    ifrom = V3(*(torch.from_numpy(froms[:, i].copy()) for i in range(3)))
    iray = V3(*(torch.from_numpy(dirs[:, i].copy()) for i in range(3)))
    seed_t = torch.from_numpy(seeds.view(np.int32).copy())
    before = tracer.LAUNCHES
    colt, distt = tracer.trace_wave(sc.tworld, sc.cfg, ifrom, iray, seed_t,
                                    SEC)
    fbt, dist_p = tracer.trace_wave(sc.tworld, sc.cfg, ifrom, iray, seed_t,
                                    SEC, pack=True)
    return dict(
        colj=np.stack([np.asarray(c) for c in colj], axis=1),
        distj=np.asarray(distj),
        colt_c4=colt, colt=np.stack([c.numpy() for c in colt], axis=1),
        distt=distt.numpy(), fbt=fbt, dist_p=dist_p,
        launches=tracer.LAUNCHES - before)


def test_trace_matches_jax_relaxed(traced):
    colt, colj = traced["colt"], traced["colj"]
    distt, distj = traced["distt"], traced["distj"]
    bit = ((colt.view(np.uint32) == colj.view(np.uint32)).all(axis=1)
           & (distt.view(np.uint32) == distj.view(np.uint32)))
    dc = np.abs(colt - colj).max(axis=1)
    dd = np.abs(distt - distj) / np.maximum(np.abs(distj), 1e-3)
    close = (dc <= 1e-4) & (dd <= 1e-5)
    msg = (f"{bit.mean():.3f} of {N} rays bit-exact, {close.mean():.3f} "
           f"within limits; max colour diff {dc.max():.3g}, max rel "
           f"distance diff {dd.max():.3g}")
    assert close.all(), msg
    assert bit.mean() >= 0.25, msg


def test_trace_outputs_are_sane(traced):
    colt, distt = traced["colt"], traced["distt"]
    assert colt.shape == (N, 4) and colt.dtype == np.float32
    assert np.isfinite(colt).all() and np.isfinite(distt).all()
    # rays start inside the level: every primary segment ends at a
    # positive distance (or a near-zero sphere-quirk value)
    assert (distt > -0.5).all()


def test_pack_matches_col_ftoint(traced):
    assert traced["fbt"].dtype == torch.int32
    assert torch.equal(traced["fbt"], col_ftoint(traced["colt_c4"]))
    assert torch.equal(traced["dist_p"].view(torch.int32),
                       torch.from_numpy(traced["distt"]).view(torch.int32))


def test_cpu_trace_does_not_launch(traced):
    assert traced["launches"] == 0


def test_to_i32_saturates_like_xla():
    x = np.array([1e30, -1e30, np.nan, 3e9, -3e9, 2147483520.0,
                  -2147483648.0, -1.7, 1.7, np.inf, -np.inf], np.float32)
    got = to_i32(torch.from_numpy(x)).numpy()
    want = np.asarray(jnp.asarray(x).astype(jnp.int32))
    assert np.array_equal(got, want)


def test_unported_config_raises():
    sc = flagship_scene(8, 2, "cpu", n_spheres=3)
    rays = V3(*(torch.ones(4) for _ in range(3)))
    seeds = torch.zeros(4, dtype=torch.int32)
    for kw in (dict(fused=True), dict(parity=True, fused=True),
               dict(profile=True), dict(probe="fire1"), dict(water=False)):
        cfg = dataclasses.replace(sc.cfg, **kw)
        with pytest.raises(NotImplementedError):
            tracer.trace_wave(sc.tworld, cfg, rays, rays, seeds, SEC)
    with pytest.raises(ValueError):
        tracer.trace_wave(sc.tworld, dataclasses.replace(sc.cfg, samples=0),
                          rays, rays, seeds, SEC)
    # a one-page world has no page 1 to start on
    with pytest.raises(ValueError):
        tracer.trace_wave(sc.tworld, sc.cfg, rays, rays, seeds, SEC, page0=1)
    with pytest.raises(ValueError):
        render_frame(sc.tworld, sc.meta,
                     dataclasses.replace(sc.cfg, cam_page=1),
                     *sc.frame_args(0))
    maze = maze_scene(8, 4, "cpu")
    with pytest.raises(NotImplementedError):
        tracer.trace_wave(maze.tworld,
                          dataclasses.replace(maze.cfg, parity=True), rays,
                          rays, seeds, SEC)
