"""K1's measurement knobs in every combination the JAX package accepts, in
the port's plain tracer: RenderConfig.profile, water=False and the eight
probes, in parity mode, with samples > 1 and with the fused wave loop,
several at once, and the unpacked colour.

  * `check_config` raises NotImplementedError for nothing: over parity x
    samples {1, 2} x fused x profile x water x probe ("" and the eight),
    it raises ValueError exactly where JAX's trace_wave_env asserts (the
    fused loop, which parity mode and profile runs ignore, with samples
    > 1), and every other combination selects a kernel instance;
  * against JAX's jnp backend, on the frame rays of a 24x16 frame of the
    demo level without spheres (reflect 1, 24 steps a segment: the op-by-op
    run's time grows with the steps): parity mode with profile,
    water=False and pad64 at once, colour, distance and per-wave tstep
    bit for bit - JAX's chain run op by op where XLA:CPU contracts
    multiply-adds (tests/fputil.fma_contracts), jitted where it does not;
    in fast mode, the colour unpacked, samples 2 with water=False and
    sel64, and the fused loop with water=False and fetch2x, against the
    jitted JAX trace within the fast-mode limits of
    tests/test_torch_tracer.py, the camera 0.13/0.07 off the spawn
    cell's centre (tests/test_torch_cameras.py says why).  The three JAX
    runs go in three threads.  Without spheres they take 4-9 s each;
    with the 14-sphere creature the op-by-op parity run took 110-130 s
    and each jitted one 37-54 s (measured), past this file's budget;
  * on the demo level with the 14-sphere creature at 24x16 (reflect 1,
    32 steps a segment): with
    samples 2, water=False and a probe, in each mode, the colour is the
    mean of the one-sample traces on the seed streams seed + k*0x9E3779B9
    (tests/test_torch_samples_split.py's identity), and the fused loop
    with water=False and fetch2x gives the unfused trace's distance bit
    for bit and its colour within tests/test_torch_fused.py's 3e-6, scaled
    by the colour where it exceeds 1 (the creature's frame reaches 42,
    where an ulp is 3.8e-6, without the knobs too);
  * every probe leaves fb and dist bit-equal to probe="" in parity mode,
    with samples 2 in both modes and in the fused loop, and water=False
    changes some ray of each (the frames reach the water)."""

import dataclasses
import itertools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pwnfps_tpu.ops.tracer_jnp import trace_wave as jax_trace_wave
from pwnfps_tpu.ops.vec import V3 as JV3
from pwnfps_tpu_torch.ops import tracer
from pwnfps_tpu_torch.ops.tracer_core import PROBES, check_config
from pwnfps_tpu_torch.render.frame import frame_rays
from pwnfps_tpu_torch.scene import flagship_scene, parity_scene
from pwnfps_tpu_torch.tools.occupancy import sample_seeds

from .fputil import fma_contracts
from .test_torch_variants import _jax_chain

W, H = 24, 16
SEC = np.float32(2.5)           # test_torch_variants' _jax_chain's clock
MAXSTEPS = 32
REFLECT = 1
OFF = (0.13, 0.07)              # fast camera offset from the cell centre
# the combinations held against JAX: (parity, RenderConfig fields)
JAX_COMBOS = {
    "parity+profile+nowater+pad64": (True, dict(profile=True, water=False,
                                                probe="pad64")),
    "samples2+nowater+sel64": (False, dict(samples=2, water=False,
                                           probe="sel64")),
    "fused+nowater+fetch2x": (False, dict(fused=True, water=False,
                                          probe="fetch2x")),
}


def _scene(parity: bool, **kw):
    make = parity_scene if parity else flagship_scene
    sc = make(W, H, "cpu", **{"maxsteps": MAXSTEPS, "reflect": REFLECT,
                              **kw})
    if not parity:
        sc.cam[3, 0] += OFF[0]
        sc.cam[3, 2] += OFF[1]
    return sc


def _inputs(sc):
    origin, rayb, rdx, rdy, _ = sc.frame_args(1)
    return (sc, *frame_rays(sc.cfg, origin, rayb, rdx, rdy, "cpu"))


@pytest.fixture(scope="module")
def scenes():
    """{parity: (scene, ifrom, rays, seeds)} on frame 1 of each path,
    the demo level with the 14-sphere creature."""
    return {parity: _inputs(_scene(parity)) for parity in (False, True)}


def _jax_args(ifrom, rays, seeds):
    return (JV3(*(jnp.asarray(t.numpy()) for t in ifrom)),
            JV3(*(jnp.asarray(t.numpy()) for t in rays)),
            jnp.asarray(seeds.numpy().view(np.uint32)))


def _jax_run(sc, cfg, ifrom, rays, seeds):
    """JAX's trace of the rays under cfg: (colour [n, 4], dist, tstep
    [n_waves, n] or None).  Parity mode: the chain of
    test_torch_variants (its per-wave tstep), op by op where XLA:CPU
    contracts multiply-adds; fast mode: the jitted trace_wave."""
    world = jax.tree.map(jnp.asarray, sc.world)
    args = _jax_args(ifrom, rays, seeds)
    if cfg.parity:
        if fma_contracts():
            with jax.disable_jit():
                col, dist, ts = _jax_chain(world, sc.meta, cfg, *args, None)
        else:
            col, dist, ts = _jax_chain(world, sc.meta, cfg, *args, None)
        ts = np.asarray(ts)
    else:
        col, dist = jax.jit(lambda f, r, s: jax_trace_wave(
            world, sc.meta, cfg, f, r, s, SEC))(*args)
        ts = None
    return (np.stack([np.asarray(c) for c in col], axis=1),
            np.asarray(dist), ts)


@pytest.fixture(scope="module")
def jax_runs():
    """Each of JAX_COMBOS on the sphere-free demo level: the port's
    inputs and configuration, and JAX's result, in three threads."""
    cases = {}
    for name, (parity, kw) in JAX_COMBOS.items():
        sc, ifrom, rays, seeds = _inputs(_scene(parity, n_spheres=0,
                                                maxsteps=24))
        cases[name] = (sc, dataclasses.replace(sc.cfg, **kw), ifrom, rays,
                       seeds)
    with ThreadPoolExecutor(len(cases)) as ex:
        futs = {name: ex.submit(_jax_run, *case)
                for name, case in cases.items()}
        return {name: (cases[name], f.result()) for name, f in futs.items()}


def _trace(scenes, parity, pack=True, **kw):
    sc, ifrom, rays, seeds = scenes[parity]
    cfg = dataclasses.replace(sc.cfg, **kw)
    return tracer.trace_wave(sc.tworld, cfg, ifrom, rays, seeds, SEC,
                             pack=pack)


def _c4(col) -> np.ndarray:
    return np.stack([c.numpy() for c in col], axis=1)


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(a).view(np.uint32)


@pytest.mark.parametrize("probe", ("",) + PROBES)
def test_check_config_accepts_what_jax_accepts(probe):
    sc = flagship_scene(8, 4, "cpu")
    for parity, samples, fused, profile, water in itertools.product(
            (False, True), (1, 2), (False, True), (False, True),
            (True, False)):
        cfg = dataclasses.replace(sc.cfg, parity=parity, samples=samples,
                                  fused=fused, profile=profile,
                                  water=water, probe=probe)
        # trace_wave_env's only assert (tracer_core.py:1763-1764)
        refused = fused and not parity and not profile and samples != 1
        if refused:
            with pytest.raises(ValueError, match="one sample"):
                check_config(cfg)
            continue
        check_config(cfg)
        entry, key = tracer.instance(cfg, 1)
        assert entry in ("tracer", "variant", "parity_variant", "flags")
        assert key in (tracer.RENDERING + tracer.STRUCTURES
                       + tuple(tracer.VARIANTS)), (cfg, entry, key)


def test_parity_combination_matches_jax(jax_runs):
    (sc, cfg, ifrom, rays, seeds), (jcol, jdist, jts) = jax_runs[
        "parity+profile+nowater+pad64"]
    fb, dist, tstep = tracer.trace_wave_profile(sc.tworld, cfg, ifrom, rays,
                                                seeds, SEC)
    col, dist_u = tracer.trace_wave(sc.tworld, cfg, ifrom, rays, seeds, SEC)
    assert np.array_equal(_bits(_c4(col)), _bits(jcol))
    assert np.array_equal(_bits(dist.numpy()), _bits(jdist))
    assert np.array_equal(tstep.numpy(), jts)
    assert tstep.shape == (cfg.n_waves, W * H) and bool((tstep[0] >= 1).all())
    assert torch.equal(dist_u.view(torch.int32), dist.view(torch.int32))


@pytest.mark.parametrize("name", ["samples2+nowater+sel64",
                                  "fused+nowater+fetch2x"])
def test_fast_combination_matches_jax(jax_runs, name):
    (sc, cfg, ifrom, rays, seeds), (jcol, jdist, _) = jax_runs[name]
    col, dist = tracer.trace_wave(sc.tworld, cfg, ifrom, rays, seeds, SEC)
    colt = _c4(col)
    dc = np.abs(colt - jcol).max(axis=1)
    dd = np.abs(dist.numpy() - jdist) / np.maximum(np.abs(jdist), 1e-3)
    bit = ((_bits(colt) == _bits(jcol)).all(axis=1)
           & (_bits(dist.numpy()) == _bits(jdist)))
    msg = (f"{bit.mean():.3f} of {W * H} rays bit-exact; max colour diff "
           f"{dc.max():.3g}, max rel distance diff {dd.max():.3g}")
    assert dc.max() <= 1e-4 and dd.max() <= 1e-5, msg
    assert bit.mean() >= 0.25, msg


@pytest.mark.parametrize("parity", [False, True], ids=["fast", "parity"])
def test_samples_combination_is_the_sample_mean(scenes, parity):
    kw = dict(water=False, probe="fire1" if parity else "pad64d")
    sc, ifrom, rays, seeds = scenes[parity]
    fb, dist = _trace(scenes, parity, samples=2, **kw)
    one = dataclasses.replace(sc.cfg, **kw)
    acc = None
    for k in range(2):
        col, d = tracer.trace_wave(sc.tworld, one, ifrom, rays,
                                   sample_seeds(seeds, k), SEC)
        acc = col if acc is None else acc + col
        if k == 0:
            assert torch.equal(d.view(torch.int32), dist.view(torch.int32))
    want = tracer.col_ftoint(acc * float(np.float32(1.0 / 2)))
    assert torch.equal(fb, want)


def test_fused_combination_against_unfused(scenes):
    kw = dict(water=False, probe="fetch2x")
    col, dist = _trace(scenes, False, pack=False, fused=True, **kw)
    ucol, udist = _trace(scenes, False, pack=False, **kw)
    assert torch.equal(udist.view(torch.int32), dist.view(torch.int32))
    a, b = _c4(ucol), _c4(col)
    assert (np.abs(a - b) <= 3e-6 * np.maximum(1.0, np.abs(a))).all()


STRUCTURES = {"parity": (True, {}), "parity_samples2": (True, {"samples": 2}),
              "samples2": (False, {"samples": 2}),
              "fused": (False, {"fused": True})}


@pytest.mark.parametrize("structure", list(STRUCTURES))
def test_probes_leave_the_bits(scenes, structure):
    parity, kw = STRUCTURES[structure]
    fb0, d0 = _trace(scenes, parity, **kw)
    for probe in PROBES:
        fb, d = _trace(scenes, parity, probe=probe, **kw)
        assert torch.equal(fb, fb0), probe
        assert torch.equal(d.view(torch.int32), d0.view(torch.int32)), probe
    fbw, dw = _trace(scenes, parity, water=False, **kw)
    assert torch.equal(dw.view(torch.int32), d0.view(torch.int32))
    assert bool((fbw != fb0).any())          # some ray reaches the water
