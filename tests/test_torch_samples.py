"""Multi-sample path tracing in the port (BASELINE config #5) against its
own per-sample calls and against the JAX package.

cfg.samples > 1 traces the primary wave once and runs one bounce chain
from it per sample, sample k's seed stream being seed + k*0x9E3779B9
(uint32), and returns the chains' mean, summed in sample order and
scaled by f32(1/samples); the distance is the primary wave's
(pwnfps_tpu/ops/tracer_core.py:1749-1817).

(a) the port's samples path equals its own per-sample calls
    (samples=1 with the Weyl seeds, accumulated in order) bit for bit,
    on the demo level and on the paged maze (the counterpart of
    tests/test_samples.py:66, which reads the reference checkout's
    level);
(b) the plain tracer at samples=2, reflect=2 against the JAX package's
    `trace_wave` (tracer_jnp), jitted whole: eager, it compiles each of
    its five segment loops apart, which takes 1.5x as long;
(c) config #5's shape, samples=4 and reflect=6, against a JAX chain
    built from the package's `run_segment` (jitted once for all 25
    segments) and `shade_and_bounce`, op for op as tracer_core.py:
    1766-1817: eager `trace_wave` would compile each segment's loop
    apart, and jitting the whole chain fuses the blend into FMAs;
(d) a 48x32 frame of `render_accumulated` against JAX's
    (backend jnp, samples=2, reflect=1, one DoF pass);
(e) samples > 1 in parity mode: the 8x4 parity frame of config #5's
    scene (reflect 6, samples 4, one DoF pass) equals the mean of its
    own per-sample traces, packed and blurred, bit for bit (the scalar
    spec stops at reflect 2: tests/test_torch_parity_samples.py holds
    the parity chains to it there).

(b)-(d) take the fast-mode limits of tests/test_torch_tracer.py and
tests/test_torch_frame.py, set there from the measured gap between
XLA:CPU and eager torch, with one change in (c): a colour is held
within 1e-4 or 1e-5 of its magnitude, whichever is larger.  Each wall
hit multiplies a chain's colour by its palette entry (30 for the
ceiling), so seven-wave chains reach colours of several hundred, and
the gap, ULPs of each wave compounded, grows with depth: 3.8e-6 at
reflect 1, 1.8e-4 at reflect 6 on a colour of 383, 1.2e-6 of it (XLA:CPU
against eager torch, 64 rays).  The three JAX computations run in three
threads: XLA:CPU compiles each in one thread, and the compiles are most
of this file's time."""

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
from pwnfps_tpu.ops.tracer_jnp import trace_wave as jax_trace_wave
from pwnfps_tpu.ops.vec import C4 as JC4
from pwnfps_tpu.ops.vec import V3 as JV3
from pwnfps_tpu.render.frame import render_accumulated as jax_accumulated
from pwnfps_tpu_torch.ops import blur, tracer
from pwnfps_tpu_torch.ops.tracer_core import col_ftoint
from pwnfps_tpu_torch.ops.vec import V3
from pwnfps_tpu_torch.render.frame import (gen_rays, pixel_seeds,
                                           render_accumulated)
from pwnfps_tpu_torch.scene import flagship_scene, maze_scene, ptrace_scene

from .test_torch_paged import _portal_rays
from .test_torch_tracer import _rays

SEC = np.float32(1.75)
FW, FH = 48, 32


def _scene(**cfg_kw):
    """The demo level with six creature spheres in view of the rays'
    start cells (config #5's spheres sit inside a wall of this level)."""
    return flagship_scene(8, 2, "cpu", n_spheres=6, **cfg_kw)


def _torch_rays(froms, dirs, seeds):
    return (V3(*(torch.from_numpy(froms[:, i].copy()) for i in range(3))),
            V3(*(torch.from_numpy(dirs[:, i].copy()) for i in range(3))),
            torch.from_numpy(seeds.view(np.int32).copy()))


def _jax_rays(froms, dirs, seeds):
    return (JV3(*(jnp.asarray(froms[:, i]) for i in range(3))),
            JV3(*(jnp.asarray(dirs[:, i]) for i in range(3))),
            jnp.asarray(seeds))


def _stack(col):
    return np.stack([np.asarray(c) for c in col], axis=1)


def _bits_equal(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


# ---- (a) the samples path equals the port's own per-sample calls -----------

def _per_sample(tw, cfg, ifrom, iray, seeds, page0=0, sec=SEC):
    """cfg.samples calls at samples=1, seeds + k*0x9E3779B9, summed in
    order and scaled by f32(1/samples): (C4, dist of sample 0, C4 of
    sample 0)."""
    one = dataclasses.replace(cfg, samples=1)
    u = seeds.numpy().view(np.uint32)
    for k in range(cfg.samples):
        sk = u + np.uint32((k * 0x9E3779B9) & 0xFFFFFFFF)
        col, dist = tracer.trace_wave(tw, one, ifrom, iray,
                                      torch.from_numpy(sk.view(np.int32)),
                                      sec, page0=page0)
        if k == 0:
            acc, dist0, col0 = col, dist, col
        else:
            acc = acc + col
    return acc * float(np.float32(1.0 / cfg.samples)), dist0, col0


@pytest.mark.parametrize("world", ["demo", "maze"])
def test_samples_equal_per_sample_calls(world):
    if world == "demo":
        sc = _scene(maxsteps=256, reflect=3, samples=3)
        rays = _rays(96, seed0=23)
    else:
        sc = maze_scene(8, 4, "cpu", samples=2)
        rays = _portal_rays(sc.world, 32)
    ifrom, iray, seeds = _torch_rays(*rays)
    page0 = sc.cfg.cam_page
    col, dist = tracer.trace_wave(sc.tworld, sc.cfg, ifrom, iray, seeds, SEC,
                                  page0=page0)
    want, want_d, _ = _per_sample(sc.tworld, sc.cfg, ifrom, iray, seeds,
                                  page0)
    for a, b in zip(col, want):
        assert _bits_equal(a, b)
    assert _bits_equal(dist, want_d)
    fb, dist_p = tracer.trace_wave(sc.tworld, sc.cfg, ifrom, iray, seeds,
                                   SEC, pack=True, page0=page0)
    assert torch.equal(fb, col_ftoint(col)) and _bits_equal(dist_p, dist)
    # the chains differ, so the mean is not sample 0's colour
    first, _ = tracer.trace_wave(sc.tworld,
                                 dataclasses.replace(sc.cfg, samples=1),
                                 ifrom, iray, seeds, SEC, page0=page0)
    assert not torch.equal(torch.stack(list(col)), torch.stack(list(first)))


def accumulated_equals_mean(sc, k, samples):
    """Frame k of sc through render_accumulated equals the mean of its
    per-sample traces, packed and blurred as the frame is, bit for bit;
    returns the frame."""
    w, h = sc.cfg.width, sc.cfg.height
    origin, rayb, rdx, rdy, sec = args = sc.frame_args(k)
    fb, zb = render_accumulated(sc.tworld, sc.meta, sc.cfg, *args,
                                samples=samples)
    rays = gen_rays(torch.from_numpy(rayb), torch.from_numpy(rdx),
                    torch.from_numpy(rdy), w, h, sc.cfg.parity)
    ifrom = V3(*(torch.full((w * h,), float(origin[i])) for i in range(3)))
    col, dist, col0 = _per_sample(
        sc.tworld, dataclasses.replace(sc.cfg, samples=samples), ifrom,
        rays, pixel_seeds(w, h, "cpu"), sec=sec)
    want_z = dist.reshape(h, w)
    want = col_ftoint(col).reshape(h, w)
    if sc.cfg.postproc_blur:
        want = blur.dof_blur(want, want_z, sc.cfg.postproc_blur)
    assert torch.equal(fb, want)
    assert _bits_equal(zb, want_z)
    # the chains differ, so the mean is not sample 0's colour
    assert not torch.equal(col_ftoint(col), col_ftoint(col0))
    return fb


# ---- (b)-(d) against the JAX package ---------------------------------------

_jax_trace_wave = jax.jit(jax_trace_wave, static_argnames=("meta", "cfg"))


@partial(jax.jit, static_argnames=("meta", "cfg"))
def _jax_segment(world, meta, cfg, ifrom, iray, active):
    return JC.run_segment(make_env(world, meta, cfg), cfg, ifrom, iray,
                          active)


def _jax_samples(world, meta, cfg, ifrom, iray, seed):
    """JAX trace_wave_env with samples (tracer_core.py:1766-1817), each
    segment through the jitted run_segment: (C4 mean, primary dist)."""
    env = make_env(world, meta, cfg)
    sec = jnp.float32(SEC)
    one = jnp.ones_like(ifrom.x)
    icol0 = JC4(one, one, one, one)
    out0 = _jax_segment(world, meta, cfg, ifrom, iray, one > 0.0)

    def chain(seed):
        bases, refls, bounces, fogs = [], [], [], []
        out, icol = out0, icol0
        for k in range(cfg.n_waves):
            if k > 0:
                out = _jax_segment(world, meta, cfg, cur_from, cur_ray, act)
            base, refl, bounce, mpos, mray, seed = JC.shade_and_bounce(
                out, icol, seed, sec, k < cfg.reflect, env, water=cfg.water)
            bases.append(base)
            refls.append(refl)
            bounces.append(bounce)
            fogs.append(out.tfog)
            icol = base
            cur_from, cur_ray, act = mpos, mray, bounce
        col = bases[-1]
        for k in range(cfg.n_waves - 2, -1, -1):
            blended = refls[k] * col + (jnp.float32(1.0) - refls[k]) * bases[k]
            fogf = env.math.exp(jnp.float32(-0.6) * fogs[k])
            fogged = fogf * blended + (jnp.float32(1.0) - fogf)
            res = fogged.where(fogs[k] != jnp.float32(0.0), blended)
            col = res.where(bounces[k], bases[k])
        return col

    acc = None
    for smp in range(cfg.samples):
        col = chain(seed + jnp.uint32((smp * 0x9E3779B9) & 0xFFFFFFFF))
        acc = list(col) if acc is None else [a + c for a, c in zip(acc, col)]
    inv = jnp.float32(1.0 / cfg.samples)
    return JC4(*(a * inv for a in acc)), out0.tdist


@pytest.fixture(scope="module")
def traced():
    """(b)'s and (c)'s rays and (d)'s frame through JAX (three threads)
    and the port."""
    sc_b = _scene(reflect=2, samples=2)
    sc_c = _scene(reflect=6, samples=4)
    sc_d = ptrace_scene(FW, FH, "cpu", samples=2, reflect=1)
    rays_b, rays_c = _rays(64, seed0=31), _rays(64, seed0=37)
    args = sc_d.frame_args(2)
    jw = jax.tree.map(jnp.asarray, sc_b.world)
    jw_d = jax.tree.map(jnp.asarray, sc_d.world)
    with ThreadPoolExecutor(3) as pool:
        jframe = pool.submit(lambda: jax.block_until_ready(jax_accumulated(
            jw_d, sc_d.meta, sc_d.cfg, *(jnp.asarray(a) for a in args[:4]),
            args[4], samples=2)))
        jc = pool.submit(lambda: jax.block_until_ready(_jax_samples(
            jw, sc_c.meta, sc_c.cfg, *_jax_rays(*rays_c))))
        jb = pool.submit(lambda: jax.block_until_ready(_jax_trace_wave(
            jw, sc_b.meta, sc_b.cfg, *_jax_rays(*rays_b), SEC)))
        out = {}
        for key, fut, sc, rays in (("b", jb, sc_b, rays_b),
                                   ("c", jc, sc_c, rays_c)):
            colt, distt = tracer.trace_wave(sc.tworld, sc.cfg,
                                            *_torch_rays(*rays), SEC)
            colj, distj = fut.result()
            out[key] = dict(colt=_stack(colt), distt=distt.numpy(),
                            colj=_stack(colj), distj=np.asarray(distj))
        before = (tracer.LAUNCHES_SAMPLES, blur.LAUNCHES)
        fb, zb = render_accumulated(sc_d.tworld, sc_d.meta, sc_d.cfg, *args,
                                    samples=2)
        out["launches"] = (tracer.LAUNCHES_SAMPLES - before[0],
                           blur.LAUNCHES - before[1])
        jfb, jzb = jframe.result()
    out["d"] = dict(fb=fb.numpy().view(np.uint32), zb=zb.numpy(),
                    jfb=np.asarray(jfb), jzb=np.asarray(jzb))
    return out


@pytest.mark.parametrize("case,rel", [("b", 0.0), ("c", 1e-5)])
def test_samples_match_jax_relaxed(traced, case, rel):
    t = traced[case]
    colt, colj, distt, distj = t["colt"], t["colj"], t["distt"], t["distj"]
    bit = ((colt.view(np.uint32) == colj.view(np.uint32)).all(axis=1)
           & (distt.view(np.uint32) == distj.view(np.uint32)))
    diff = np.abs(colt - colj)
    dc = diff.max(axis=1)
    dd = np.abs(distt - distj) / np.maximum(np.abs(distj), 1e-3)
    limit = np.maximum(1e-4, rel * np.abs(colj))
    close = (diff <= limit).all(axis=1) & (dd <= 1e-5)
    msg = (f"{bit.mean():.3f} of {len(bit)} rays bit-exact, "
           f"{close.mean():.3f} within limits; max colour diff "
           f"{dc.max():.3g}, max rel distance diff {dd.max():.3g}")
    assert close.all(), msg
    assert bit.mean() >= 0.25, msg
    assert np.isfinite(colt).all() and np.isfinite(distt).all()


def test_accumulated_frame_matches_jax_relaxed(traced):
    d = traced["d"]
    fb, zb, jfb, jzb = d["fb"], d["zb"], d["jfb"], d["jzb"]
    assert fb.shape == jfb.shape == (FH, FW)
    bt = fb.view(np.uint8).astype(np.int32)
    bj = jfb.view(np.uint8).astype(np.int32)
    fb_bit = np.mean(fb == jfb)
    db = np.abs(bt - bj).max()
    dz = np.abs(zb - jzb) / np.maximum(np.abs(jzb), 1e-3)
    msg = (f"fb {fb_bit:.5f} bit-exact, max byte diff {db}; zbuf max rel "
           f"diff {dz.max():.3g}")
    assert fb_bit >= 0.999 and db <= 64, msg
    assert dz.max() <= 1e-5, msg
    assert np.isfinite(zb).all() and len(np.unique(fb)) > 100, msg
    assert traced["launches"] == (0, 0)       # CPU tensors: plain versions


# ---- (e) -------------------------------------------------------------------

def test_samples_in_parity_mode_raise():
    """Samples in parity mode render: the 8x4 parity frame of config
    #5's scene equals the mean of its per-sample traces.  (The name is
    the refusal this test asserted before the parity samples path was
    ported.)"""
    sc = ptrace_scene(8, 4, "cpu", parity=True)
    assert (sc.cfg.reflect, sc.cfg.samples, sc.cfg.postproc_blur) == (6, 4, 1)
    before = (tracer.LAUNCHES_PARITY, tracer.LAUNCHES_PARITY_SAMPLES)
    fb = accumulated_equals_mean(sc, 1, sc.cfg.samples)
    assert (tracer.LAUNCHES_PARITY,
            tracer.LAUNCHES_PARITY_SAMPLES) == before   # CPU: plain
    assert fb.shape == (4, 8) and torch.unique(fb).numel() > 4
