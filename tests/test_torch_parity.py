"""Parity mode of the port (pwnfps_tpu_torch), on the CPU, bit for bit
against the JAX package's scalar specification
`ops/tracer_ref.ScalarTracer(pinned=True)` - the numpy transliteration
of the reference ray march with its pinned libm.

Eager torch on the CPU neither contracts multiply-adds nor reassociates,
so the port's plain parity tracer can be held to the exact bits (colour
and distance) here, which XLA:CPU cannot (tests/fputil.py).  Checked:

  * the port's `build_world` against the JAX package's, array for
    array, on each world below;
  * the plain parity tracer against the scalar spec on random rays: the
    demo level with the 14-sphere creature (half the rays aimed at it),
    the demo level with two coincident spheres (exact ties, which go to
    the first sphere in bucket order), and the synthetic-features level
    of tests/test_synthetic_features.py (magenta portals, half-open
    portals, rotated pairs, fog, ramps, a 2-high room);
  * parity `gen_rays` against a numpy replay of the reference's serial
    per-tile accumulation (screen.h:12-24), and against the JAX
    package's `gen_rays(parity=True)`: bit for bit where XLA does not
    contract FMAs, within 2 ulp where it does;
  * the whole slice: a 32x24 parity `render_frame` without blur equal in
    every fb and zbuf bit to a frame built pixel by pixel from the scalar
    spec on the same rays and seeds; with blur, equal to the JAX
    package's `dof_blur` of that frame.  No kernel launches on the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pwnfps_tpu.core import lcg as ref_lcg
from pwnfps_tpu.core.approx import SseTables as RefTables
from pwnfps_tpu.ops import worlddev as RefW
from pwnfps_tpu.ops.blur import dof_blur as jax_dof_blur
from pwnfps_tpu.ops.tracer_ref import ScalarTracer, ScalarWorld
from pwnfps_tpu.render.frame import gen_rays as jax_gen_rays
from pwnfps_tpu.world.levelc import compile_level as ref_compile
from pwnfps_tpu.world.objects import ObjectPool as RefPool
from pwnfps_tpu_torch.core.approx import SseTables
from pwnfps_tpu_torch.ops import tracer
from pwnfps_tpu_torch.ops import worlddev as W
from pwnfps_tpu_torch.ops.vec import V3
from pwnfps_tpu_torch.ops.world import world_to_torch
from pwnfps_tpu_torch.render.frame import gen_rays, render_frame
from pwnfps_tpu_torch.scene import CREATURE, CREATURE_AT, LEVEL, parity_scene
from pwnfps_tpu_torch.world.levelc import compile_level
from pwnfps_tpu_torch.world.objects import ObjectPool

from .fputil import fma_contracts
from .test_synthetic_features import LEVEL as SYNTH_LEVEL
from .test_synthetic_features import _rays as synth_rays

SEC = np.float32(2.0)
FW, FH = 32, 24
# start cells in the creature's room and across the demo level's
# features (portals A/B, the fog room, the 2-high room, ramps)
DEMO_BASES = [(3.5, 0.5, 3.5), (2.5, 0.5, 2.5), (5.5, 0.5, 2.5),
              (6.5, 0.5, 6.5), (2.5, 0.5, 6.5), (13.5, 0.5, 3.5),
              (18.5, 0.5, 5.5), (2.5, 0.5, 9.5), (7.5, 0.5, 12.5),
              (13.5, 0.5, 13.5)]


def _demo_text() -> bytes:
    with open(LEVEL, "rb") as f:
        return f.read()


# two coincident spheres of different colour and reflectance: every hit
# is an exact tie, which the reference gives to the first in bucket order
TWINS = [(0.0, 0.0, 0.0, 0.3, 0.9, 0.1, 0.1, 0.6),
         (0.0, 0.0, 0.0, 0.3, 0.1, 0.9, 0.1, 0.2)]


def _pool(cls, spheres):
    pool = cls()
    for (x, y, z, r, b, g, rr, refl) in spheres:
        i = pool.obj_new()
        pool.obj_set_sphere(i, r, refl, CREATURE_AT[0] + x,
                            CREATURE_AT[1] + y, CREATURE_AT[2] + z, b, g, rr)
    return pool


def _ref_creature_pool(n_spheres):
    return _pool(RefPool, CREATURE[:n_spheres])


# level text and spheres of each world the tests build
LEVELS = {"demo": (_demo_text, CREATURE),
          "synthetic": (lambda: SYNTH_LEVEL, []),
          "twins": (_demo_text, TWINS)}


@pytest.fixture(scope="module", params=sorted(LEVELS))
def worlds(request):
    """(name, port world, port meta, scalar world) of one level."""
    text_fn, spheres = LEVELS[request.param]
    text = text_fn()
    world, meta = W.build_world(compile_level(text),
                                _pool(ObjectPool, spheres).prepare_render(),
                                SseTables.load())
    lv = ref_compile(text)
    sph = _pool(RefPool, spheres).prepare_render()
    ref_world, ref_meta = RefW.build_world(lv, sph, RefTables.load())
    return dict(name=request.param, world=world, meta=meta,
                ref_world=ref_world, ref_meta=ref_meta,
                scalar=ScalarWorld(lv, sph, RefTables.load()))


def test_build_world_matches_jax(worlds):
    w, r = worlds["world"], worlds["ref_world"]
    for f in RefW.WorldDev._fields:
        a, b = np.asarray(getattr(w, f)), np.asarray(getattr(r, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert dataclasses.asdict(worlds["meta"]) == \
        dataclasses.asdict(worlds["ref_meta"])


def _demo_rays(n, seed0=23):
    rng = np.random.default_rng(seed0)
    froms = np.zeros((n, 4), np.float32)
    dirs = np.zeros((n, 4), np.float32)
    for k in range(n):
        b = DEMO_BASES[k % len(DEMO_BASES)]
        froms[k] = [b[0] + rng.uniform(-0.4, 0.4),
                    b[1] + rng.uniform(-0.1, 0.4),
                    b[2] + rng.uniform(-0.4, 0.4), 1.0]
        d = rng.normal(size=3)
        if k % 2 == 0 and k % len(DEMO_BASES) < 5:
            d = np.array(CREATURE_AT) + rng.normal(size=3) * 0.15 \
                - froms[k, :3]
            d[1] /= 0.6
        d /= np.linalg.norm(d)
        dirs[k] = [d[0], d[1] * 0.6, d[2], 0.0]
    seeds = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    return froms, dirs, seeds


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def test_plain_parity_tracer_matches_scalar_spec(worlds):
    n = 64
    if worlds["name"] != "synthetic":
        froms, dirs, seeds = _demo_rays(n)
    else:
        rays = synth_rays(n, seed0=8)
        froms = np.stack([r["from"] for r in rays])
        dirs = np.stack([r["dir"] for r in rays])
        seeds = np.array([r["seed"] for r in rays], np.uint32)
    wt = world_to_torch(worlds["world"], worlds["meta"], "cpu")
    cfg = parity_scene(8, 4, "cpu").cfg
    col, dist = tracer.trace_wave(
        wt, cfg, V3(*(torch.from_numpy(froms[:, i].copy())
                      for i in range(3))),
        V3(*(torch.from_numpy(dirs[:, i].copy()) for i in range(3))),
        torch.from_numpy(seeds.view(np.int32).copy()), SEC)
    colv = np.stack([c.numpy() for c in col], 1)
    distv = dist.numpy()
    bad = []
    for k in range(n):
        tr = ScalarTracer(worlds["scalar"], sec_current=SEC, pinned=True)
        c, d, _ = tr.trace(froms[k], dirs[k], int(seeds[k]))
        if not (np.array_equal(_bits(colv[k]), _bits(c))
                and _bits(distv[k]) == _bits(d)):
            bad.append((k, colv[k], c, distv[k], d))
    assert not bad, f"{len(bad)} of {n} rays differ, first {bad[:2]}"


def _replay_gen_rays(rayb, rdx, rdy, w, h):
    """screen.h:12-24 in numpy f32: each row starts every 32-pixel tile
    at (rayb + y*rdy) + (32t)*rdx and adds rdx once per pixel."""
    out = np.zeros((3, h, w), np.float32)
    for y in range(h):
        for t0 in range(0, w, 32):
            acc = (rayb + np.float32(y) * rdy) + np.float32(t0) * rdx
            for x in range(t0, min(t0 + 32, w)):
                acc = acc + rdx
                out[:, y, x] = acc
    return out.reshape(3, -1)


@pytest.mark.parametrize("w,h,k", [(FW, FH, 0), (45, 7, 3)])
def test_parity_gen_rays(w, h, k):
    sc = parity_scene(w, h, "cpu")
    _, rayb, rdx, rdy, _ = sc.frame_args(k)
    got = gen_rays(torch.from_numpy(rayb), torch.from_numpy(rdx),
                   torch.from_numpy(rdy), w, h, parity=True)
    got = np.stack([c.numpy() for c in got])
    want = _replay_gen_rays(rayb, rdx, rdy, w, h)
    assert np.array_equal(_bits(got), _bits(want))
    jv = jax_gen_rays(jnp.asarray(rayb), jnp.asarray(rdx),
                      jnp.asarray(rdy), w, h, True)
    jv = np.stack([np.asarray(c) for c in jv])
    if not fma_contracts():
        assert np.array_equal(_bits(got), _bits(jv))
    else:
        ulp = np.spacing(np.maximum(np.abs(got), np.abs(jv)))
        assert (np.abs(got - jv) <= 2 * ulp).all()


@pytest.fixture(scope="module")
def frame_pair():
    """The port's 32x24 parity frame (frame 0 of the parity camera
    path: the creature in view) without blur, and the same frame built
    from the scalar spec on the same rays and seeds."""
    sc = parity_scene(FW, FH, "cpu", postproc_blur=0)
    origin, rayb, rdx, rdy, sec = sc.frame_args(0)
    before = (tracer.LAUNCHES, tracer.LAUNCHES_PARITY)
    fb, zb = render_frame(sc.tworld, sc.meta, sc.cfg, origin, rayb, rdx,
                          rdy, sec)
    launches = (tracer.LAUNCHES - before[0],
                tracer.LAUNCHES_PARITY - before[1])
    rays = _replay_gen_rays(rayb, rdx, rdy, FW, FH)
    xs = np.arange(FW, dtype=np.uint32)
    ys = np.arange(FH, dtype=np.uint32)
    seeds = ref_lcg.pixel_seed(xs[None, :], ys[:, None], FW).reshape(-1)
    lv = ref_compile(_demo_text())
    sw = ScalarWorld(lv, _ref_creature_pool(len(CREATURE)).prepare_render(),
                     RefTables.load())
    frm = np.array([*origin, 1.0], np.float32)
    cols = np.zeros((FW * FH, 4), np.float32)
    dists = np.zeros(FW * FH, np.float32)
    for i in range(FW * FH):
        tr = ScalarTracer(sw, sec_current=sec, pinned=True)
        ray = np.array([rays[0, i], rays[1, i], rays[2, i], 0.0],
                       np.float32)
        cols[i], dists[i], _ = tr.trace(frm, ray, int(seeds[i]))
    # util.h:48-59 pack: round half to even, clamp, >= 2^31 or NaN -> 0
    v = cols * np.float32(255.0)
    with np.errstate(invalid="ignore"):
        q = np.clip(np.rint(v), 0.0, 255.0)
        q[(v >= np.float32(2 ** 31)) | np.isnan(v)] = 0
    q = q.astype(np.uint32)
    ref_fb = (q[:, 0] | (q[:, 1] << 8) | (q[:, 2] << 16) | (q[:, 3] << 24))
    return dict(sc=sc, fb=fb, zb=zb, launches=launches,
                ref_fb=ref_fb.reshape(FH, FW), ref_zb=dists.reshape(FH, FW),
                args=(origin, rayb, rdx, rdy, sec))


def test_parity_frame_matches_scalar_spec(frame_pair):
    fb = frame_pair["fb"].numpy().view(np.uint32)
    zb = frame_pair["zb"].numpy()
    assert fb.shape == (FH, FW) and zb.shape == (FH, FW)
    assert np.array_equal(fb, frame_pair["ref_fb"]), \
        f"{(fb != frame_pair['ref_fb']).sum()} pixels differ"
    assert np.array_equal(_bits(zb), _bits(frame_pair["ref_zb"]))
    assert len(np.unique(fb)) > 100          # not a flat frame
    assert frame_pair["launches"] == (0, 0)


def test_parity_frame_with_blur_matches_jax_blur(frame_pair):
    sc = frame_pair["sc"]
    cfg = dataclasses.replace(sc.cfg, postproc_blur=1)
    before = tracer.LAUNCHES_PARITY
    fb, zb = render_frame(sc.tworld, sc.meta, cfg, *frame_pair["args"])
    assert tracer.LAUNCHES_PARITY == before
    want = np.asarray(jax_dof_blur(jnp.asarray(frame_pair["ref_fb"]),
                                   jnp.asarray(frame_pair["ref_zb"]), 1))
    assert np.array_equal(fb.numpy().view(np.uint32), want)
    assert np.array_equal(_bits(zb.numpy()), _bits(frame_pair["ref_zb"]))
