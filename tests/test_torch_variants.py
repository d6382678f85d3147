"""K1's measurement instances in the port's plain tracer: the eight
calibration pads of RenderConfig.probe, water=False and profile=True
(each ray's terminal DDA step count a wave), fast mode with one sample
(and, below, the combinations).

  * every probe leaves fb and dist bit-equal to probe="" (the pads'
    results are thrown away behind a data-opaque select), on the demo
    level's random rays and on a paged maze frame from the portal camera;
  * water=False against JAX's trace with water=False on 64 rays at
    maxsteps=48 (reflect 1), within test_torch_tracer.py's fast-mode
    limits;
  * the per-wave tstep bit-equal to JAX's with profile=True, on rays
    that cross the maze's cross-page portals, at a maxsteps (6) that some
    lanes exhaust (reflect 1);
  * profile leaves fb and dist bit-unchanged;
  * the knobs in parity mode, with samples > 1, with the fused loop and
    several at once run too (tests/test_torch_measure_combos.py holds
    them against JAX), a probe leaving the bits of the same knobs
    without it.

Both JAX runs are a jitted chain of `run_segment` + `shade_and_bounce`
and the unwind blend (trace_wave_env at samples 1, the chain
tests/test_torch_paged.py uses; it compiles in half the time of the
jitted `trace_wave`), compiled in two threads (XLA:CPU compiles each in
one)."""

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pwnfps_tpu.ops import tracer_core as JC
from pwnfps_tpu.ops.tracer_jnp import make_env
from pwnfps_tpu.ops.vec import C4 as JC4
from pwnfps_tpu.ops.vec import V3 as JV3
from pwnfps_tpu_torch.ops import tracer
from pwnfps_tpu_torch.ops.vec import V3
from pwnfps_tpu_torch.render.frame import frame_rays
from pwnfps_tpu_torch.scene import flagship_scene, maze_scene, portal_camera

from .test_torch_paged import _portal_rays
from .test_torch_tracer import _rays

N = 64
SEC = np.float32(2.5)
TSTEP_MAXSTEPS = 6
# two waves a chain keep the JAX compiles short; the second wave has
# lanes whose chain ended (tstep 0)
REFLECT = 1


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _torch_rays(froms, dirs, seeds):
    return (V3(*(_t(froms[:, i]) for i in range(3))),
            V3(*(_t(dirs[:, i]) for i in range(3))),
            _t(seeds.view(np.int32)))


def _jax_rays(froms, dirs, seeds):
    return (JV3(*(jnp.asarray(froms[:, i]) for i in range(3))),
            JV3(*(jnp.asarray(dirs[:, i]) for i in range(3))),
            jnp.asarray(seeds))


@partial(jax.jit, static_argnames=("meta", "cfg"))
def _jax_chain(world, meta, cfg, ifrom, iray, seed, page):
    """JAX trace_wave_env at samples == 1 (tracer_core.py:1766-1805):
    (colour C4, primary distance, each wave's SegOut.tstep)."""
    env = make_env(world, meta, cfg)
    one = jnp.ones_like(ifrom.x)
    active = one > 0.0
    icol = JC4(one, one, one, one)
    bases, refls, bounces, fogs, tsteps = [], [], [], [], []
    for k in range(cfg.n_waves):
        out = JC.run_segment(env, cfg, ifrom, iray, active, page)
        if k == 0:
            dist0 = out.tdist
        tsteps.append(out.tstep)
        page = out.tpage
        base, refl, bounce, ifrom, iray, seed = JC.shade_and_bounce(
            out, icol, seed, jnp.float32(SEC), k < cfg.reflect, env,
            water=cfg.water)
        bases.append(base)
        refls.append(refl)
        bounces.append(bounce)
        fogs.append(out.tfog)
        icol = base
        active = bounce
    col = bases[-1]
    for k in range(cfg.n_waves - 2, -1, -1):
        blended = refls[k] * col + (jnp.float32(1.0) - refls[k]) * bases[k]
        fogf = env.math.exp(jnp.float32(-0.6) * fogs[k])
        fogged = fogf * blended + (jnp.float32(1.0) - fogf)
        res = fogged.where(fogs[k] != jnp.float32(0.0), blended)
        col = res.where(bounces[k], bases[k])
    return col, dist0, jnp.stack(tsteps)


@pytest.fixture(scope="module")
def demo():
    sc = flagship_scene(32, 2, "cpu", n_spheres=3, maxsteps=48)
    return sc, _rays(N)


@pytest.fixture(scope="module")
def maze():
    sc = maze_scene(24, 16, "cpu")
    sc.cam = portal_camera(sc)
    return sc


@pytest.fixture(scope="module")
def jax_runs(demo, maze):
    """JAX's water=False trace of the demo rays and its per-wave tstep of
    the maze's portal rays, compiled in two threads."""
    sc, (froms, dirs, seeds) = demo
    cfg_w = dataclasses.replace(sc.cfg, water=False, reflect=REFLECT)
    pf, pd, ps = _portal_rays(maze.world, N)
    cfg_p = dataclasses.replace(maze.cfg, profile=True, reflect=REFLECT,
                                maxsteps=TSTEP_MAXSTEPS)
    jmaze = jax.tree.map(jnp.asarray, maze.world)
    with ThreadPoolExecutor(2) as ex:
        water = ex.submit(lambda: jax.block_until_ready(_jax_chain(
            jax.tree.map(jnp.asarray, sc.world), sc.meta, cfg_w,
            *_jax_rays(froms, dirs, seeds), None)))
        tstep = ex.submit(lambda: jax.block_until_ready(_jax_chain(
            jmaze, maze.meta, cfg_p, *_jax_rays(pf, pd, ps),
            jnp.zeros(N, jnp.int32))))
        colj, distj, _ = water.result()
        tj = tstep.result()[2]
    return dict(colj=np.stack([np.asarray(c) for c in colj], axis=1),
                distj=np.asarray(distj), tstep=np.asarray(tj),
                portal=(pf, pd, ps), cfg_p=cfg_p)


@pytest.fixture(scope="module")
def base(demo, maze):
    """probe="" traces: the demo rays and the maze frame."""
    sc, rays = demo
    out = {"demo": tracer.trace_wave(sc.tworld, sc.cfg, *_torch_rays(*rays),
                                     SEC, pack=True)}
    ifrom, iray, seeds = frame_rays(maze.cfg, *maze.frame_args(0)[:4], "cpu")
    out["maze"] = tracer.trace_wave(maze.tworld, maze.cfg, ifrom, iray,
                                    seeds, SEC, pack=True,
                                    page0=maze.cfg.cam_page)
    return out


def _same(a, b) -> bool:
    return (torch.equal(a[0], b[0])
            and torch.equal(a[1].view(torch.int32), b[1].view(torch.int32)))


@pytest.mark.parametrize("probe", tracer.PROBES)
def test_probe_leaves_bits_unchanged(probe, demo, maze, base):
    sc, rays = demo
    before = dict(tracer.LAUNCHES_VARIANT)
    got = tracer.trace_wave(sc.tworld, dataclasses.replace(sc.cfg,
                                                           probe=probe),
                            *_torch_rays(*rays), SEC, pack=True)
    assert _same(got, base["demo"])
    ifrom, iray, seeds = frame_rays(maze.cfg, *maze.frame_args(0)[:4], "cpu")
    got = tracer.trace_wave(maze.tworld, dataclasses.replace(
        maze.cfg, probe=probe), ifrom, iray, seeds, SEC, pack=True,
        page0=maze.cfg.cam_page)
    assert _same(got, base["maze"])
    assert tracer.LAUNCHES_VARIANT == before     # the CPU runs no kernel


def test_nowater_matches_jax(demo, jax_runs):
    sc, rays = demo
    cfg = dataclasses.replace(sc.cfg, water=False, reflect=REFLECT)
    col, dist = tracer.trace_wave(sc.tworld, cfg, *_torch_rays(*rays), SEC)
    colt = np.stack([c.numpy() for c in col], axis=1)
    distt = dist.numpy()
    colj, distj = jax_runs["colj"], jax_runs["distj"]
    bit = ((colt.view(np.uint32) == colj.view(np.uint32)).all(axis=1)
           & (distt.view(np.uint32) == distj.view(np.uint32)))
    dc = np.abs(colt - colj).max(axis=1)
    dd = np.abs(distt - distj) / np.maximum(np.abs(distj), 1e-3)
    msg = (f"{bit.mean():.3f} of {N} rays bit-exact; max colour diff "
           f"{dc.max():.3g}, max rel distance diff {dd.max():.3g}")
    assert ((dc <= 1e-4) & (dd <= 1e-5)).all(), msg
    assert bit.mean() >= 0.25, msg
    # the flat floor normal changes the rays that bounce off the water
    colw, _ = tracer.trace_wave(sc.tworld, dataclasses.replace(
        cfg, water=True), *_torch_rays(*rays), SEC)
    wet = np.stack([c.numpy() for c in colw], axis=1)
    assert (wet != colt).any(axis=1).sum() > 0


def test_profile_tsteps_match_jax(maze, jax_runs):
    cfg = jax_runs["cfg_p"]
    ifrom, iray, seeds = _torch_rays(*jax_runs["portal"])
    segs = []
    tracer.trace_wave_plain(maze.tworld, cfg, ifrom, iray, seeds, SEC,
                            segs=segs)
    got = torch.stack([o.tstep for o in segs]).numpy()
    want = jax_runs["tstep"]
    assert got.shape == want.shape == (cfg.n_waves, N)
    assert np.array_equal(got, want)
    # the edges the rays reach: lanes that exhaust the budget, lanes
    # that die on its last step, lanes inactive in a later wave
    assert (want == TSTEP_MAXSTEPS).any() and (want == 0).any()
    assert ((want > 0) & (want < TSTEP_MAXSTEPS)).any()


def test_profile_leaves_frame_unchanged(maze, base):
    ifrom, iray, seeds = frame_rays(maze.cfg, *maze.frame_args(0)[:4], "cpu")
    fb, dist, tstep = tracer.trace_wave_profile(
        maze.tworld, maze.cfg, ifrom, iray, seeds, SEC,
        page0=maze.cfg.cam_page)
    assert _same((fb, dist), base["maze"])
    n = ifrom.x.shape[0]
    assert tstep.shape == (maze.cfg.n_waves, n) and tstep.dtype == torch.int32
    assert bool((tstep[0] >= 1).all())          # every primary ray steps
    assert bool((tstep <= maze.cfg.maxsteps).all())


@pytest.mark.parametrize("kw", [
    dict(profile=True, parity=True), dict(water=False, parity=True),
    dict(probe="pad64", parity=True), dict(profile=True, samples=2),
    dict(probe="fire1", samples=2), dict(water=False, fused=True),
    dict(probe="sel64", fused=True), dict(profile=True, water=False),
    dict(probe="cmp64", profile=True)],
    ids=lambda kw: "+".join(f"{k}={v}" for k, v in kw.items()))
def test_unported_combinations_raise(kw, demo):
    """Each combination runs (the JAX package accepts it): a probe leaves
    fb and dist those of the same knobs without it, and with water=False
    the distances stay those of water=True."""
    sc, rays = demo
    cfg = dataclasses.replace(sc.cfg, **kw)
    fb, dist = tracer.trace_wave(sc.tworld, cfg, *_torch_rays(*rays), SEC,
                                 pack=True)
    assert torch.isfinite(dist).all()
    base = dataclasses.replace(cfg, probe="", water=True)
    fb0, dist0 = tracer.trace_wave(sc.tworld, base, *_torch_rays(*rays),
                                   SEC, pack=True)
    assert torch.equal(dist.view(torch.int32), dist0.view(torch.int32))
    if cfg.water:
        assert torch.equal(fb, fb0)


def test_unknown_probe_raises(demo):
    sc, rays = demo
    with pytest.raises(ValueError, match="probe"):
        tracer.trace_wave(sc.tworld, dataclasses.replace(sc.cfg,
                                                         probe="pad32"),
                          *_torch_rays(*rays), SEC)
