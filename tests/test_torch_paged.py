"""The port's paged worlds (BASELINE config #3, the 1024-sector maze)
against the JAX package.

(a) the copied maze generator and `build_world_paged` give the JAX
package's words, info, `WorldDev` and `WorldMeta`; (b) `world_to_torch`
lays the four pages out flat, with the has-sphere bit and the count
cleared on portal cells (their word holds a target page there); (c) a
ray aimed into a cross-page portal ends on the target page, on the
plain tracer alone; (d) the plain paged tracer against JAX `jnp`
`trace_wave` on 64 rays started beside cross-page portals; (e) the
port's `render_frame` against JAX's at 64x32, the camera facing a
cross-page portal.

(d) and (e) take the limits of tests/test_torch_tracer.py and
tests/test_torch_frame.py, set there from the measured gap between
XLA:CPU (FMA contraction, its own rsqrt and transcendentals) and eager
torch.  The cameras and origins sit off the cell centres: a ray from a
centre through the symmetric pixel grid can meet a cell edge exactly,
where a 1-ulp difference in the normalised ray picks the ceiling or the
wall.

The JAX side of (d) is trace_wave_env's chain for samples == 1
(pwnfps_tpu/ops/tracer_core.py:1766-1805) built from the JAX package's
own `run_segment`, jitted once for all three waves, and
`shade_and_bounce`: eager `trace_wave` compiles each wave's loop apart,
which takes twice as long on this CPU, and returns no pages.  It runs in
one thread while JAX's `render_frame` for (e) compiles in another:
XLA:CPU compiles each in one thread, and the compiles are most of this
file's time."""

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pwnfps_tpu.core.approx import SseTables as JaxSseTables
from pwnfps_tpu.ops import tracer_core as JC
from pwnfps_tpu.ops import worlddev as JW
from pwnfps_tpu.ops.tracer_jnp import make_env
from pwnfps_tpu.ops.vec import C4 as JC4
from pwnfps_tpu.ops.vec import V3 as JV3
from pwnfps_tpu.render.frame import render_frame as jax_render_frame
from pwnfps_tpu.world.objects import ObjectPool as JaxObjectPool
from pwnfps_tpu.world.procgen import generate_sector_maze as jax_maze
from pwnfps_tpu_torch.core.approx import SseTables
from pwnfps_tpu_torch.ops import blur, tracer
from pwnfps_tpu_torch.ops import worlddev as W
from pwnfps_tpu_torch.ops.tracer_core import (FAST_MATH, T_WALL,
                                              run_segment)
from pwnfps_tpu_torch.ops.vec import V3
from pwnfps_tpu_torch.render.frame import gen_rays, render_frame
from pwnfps_tpu_torch.scene import (cross_page_portals, maze_scene,
                                    portal_camera)
from pwnfps_tpu_torch.world.objects import ObjectPool
from pwnfps_tpu_torch.world.procgen import generate_sector_maze

W_, H_ = 64, 32
N = 64
SEC = np.float32(0.25)


@pytest.fixture(scope="module")
def scene():
    return maze_scene(W_, H_, "cpu")


@pytest.fixture(scope="module")
def jworld(scene):
    return jax.tree.map(jnp.asarray, scene.world)


# ---- (a) the copies equal their sources ------------------------------------

@pytest.mark.parametrize("seed", [7, 3])
def test_maze_generator_equals_source(seed):
    words, info = generate_sector_maze(seed=seed)
    jwords, jinfo = jax_maze(seed=seed)
    assert words.dtype == jwords.dtype and np.array_equal(words, jwords)
    for key in ("sectors", "portal_pairs", "spawn"):
        assert info[key] == jinfo[key], key
    assert info["sector_centre"](2, 3, 5) == jinfo["sector_centre"](2, 3, 5)


def test_build_world_paged_equals_source(scene):
    words, info = jax_maze(seed=7)
    sp, sx, sz = info["spawn"]
    pool = JaxObjectPool()
    i = pool.obj_new()
    pool.obj_set_sphere(i, 0.25, 0.5, sx + 0.5, 0.35, sz + 1.2,
                        0.9, 0.6, 0.6)
    jw, jm = JW.build_world_paged(words, pool.prepare_render(), sp,
                                  JaxSseTables.load())
    for name, a, b in zip(jw._fields, scene.world, jw):
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert dataclasses.asdict(scene.meta) == dataclasses.asdict(jm)
    assert scene.meta.n_pages == 4 and scene.meta.has_clear


def test_paged_buckets_on_portal_cells_rejected():
    words, _ = generate_sector_maze(seed=3)
    z, x = np.argwhere((words.reshape(4, 64, 64)[0] & 0xF) == W.PORTAL)[0]
    pool = ObjectPool()
    i = pool.obj_new()
    pool.obj_set_sphere(i, 0.2, 0.5, x + 0.5, 0.3, z + 0.5, 1, 1, 1)
    with pytest.raises(ValueError, match="portal"):
        W.build_world_paged(words, pool.prepare_render(), 0,
                            SseTables.load())


# ---- (b) the device tables -------------------------------------------------

def test_paged_tables(scene):
    tw = scene.tworld
    assert (tw.n_pages, tw.sphere_page) == (4, 0)
    assert tw.ent.shape == (4 * 4096,) and tw.word.shape == (4 * 4096,)
    word = scene.world.word
    assert np.array_equal(tw.word.numpy(), word)
    ent = tw.ent.numpy()
    portal = (word & 0xF) == W.PORTAL
    assert portal.sum() > 100 and (W.w_dpage(word[portal]) != 0).any()
    assert not (ent[portal] & (1 << 6)).any()
    assert not ((ent[portal] >> 15) & 0x1F).any()
    # elsewhere the JAX package's entry, bit for bit (the sphere's cell
    # included); on portal cells too, once those bits are masked
    want = np.asarray(JC.decode_word(jnp.asarray(word)).ent)
    assert (ent[~portal] & (1 << 6)).any()
    assert np.array_equal(ent[~portal], want[~portal])
    keep = ~((1 << 6) | (0x1F << 15))
    assert np.array_equal(ent[portal], want[portal] & keep)


# ---- (c) cross-page traversal on the plain tracer ---------------------------

def test_cross_page_ray_traversal(scene):
    x, z, dp, dx, dz = cross_page_portals(scene.world, 0)[0]
    frm = V3(torch.tensor([x + dx + 0.5]), torch.tensor([0.5]),
             torch.tensor([z + dz + 0.5]))
    ray = V3(torch.tensor([float(-dx or 1e-6)]), torch.tensor([-0.02]),
             torch.tensor([float(-dz or 1e-6)]))
    page0 = torch.zeros(1, dtype=torch.int32)
    act = torch.ones(1, dtype=torch.bool)
    out = run_segment(scene.tworld, scene.cfg, FAST_MATH, frm, ray, act,
                      page0)
    assert int(out.tpage[0]) == dp != 0
    assert int(out.tkind[0]) == T_WALL
    up = V3(torch.tensor([1e-6]), torch.tensor([1.0]), torch.tensor([1e-6]))
    out = run_segment(scene.tworld, scene.cfg, FAST_MATH, frm, up, act,
                      page0)
    assert int(out.tpage[0]) == 0 and int(out.tkind[0]) == T_WALL


# ---- (d) the plain paged tracer against JAX jnp ----------------------------

def _portal_rays(world, n, seed=5):
    """n rays from the open cell beside page-0 cross-page portals, aimed
    at the portal with a spread of headings and small pitches."""
    rng = np.random.default_rng(seed)
    sites = cross_page_portals(world, 0)
    froms = np.zeros((n, 3), np.float32)
    dirs = np.zeros((n, 3), np.float32)
    for k in range(n):
        x, z, _, dx, dz = sites[k % len(sites)]
        froms[k] = [x + dx + 0.5 + rng.uniform(-0.35, 0.35),
                    rng.uniform(0.2, 0.8),
                    z + dz + 0.5 + rng.uniform(-0.35, 0.35)]
        side = rng.uniform(-0.6, 0.6)
        dirs[k] = [-dx + side * dz, rng.uniform(-0.3, 0.3),
                   -dz + side * dx]
    seeds = rng.integers(0, 2 ** 31, n).astype(np.uint32)
    return froms, dirs, seeds


@partial(jax.jit, static_argnames=("meta", "cfg"))
def _jax_segment(world, meta, cfg, ifrom, iray, active, page):
    return JC.run_segment(make_env(world, meta, cfg), cfg, ifrom, iray,
                          active, page)


def _jax_trace(world, meta, cfg, ifrom, iray, seed, page):
    """JAX trace_wave_env at samples == 1 (tracer_core.py:1766-1805):
    (colour C4, primary distance, primary end page)."""
    env = make_env(world, meta, cfg)
    one = jnp.ones_like(ifrom.x)
    active = one > 0.0
    icol = JC4(one, one, one, one)
    bases, refls, bounces, fogs = [], [], [], []
    for k in range(cfg.n_waves):
        out = _jax_segment(world, meta, cfg, ifrom, iray, active, page)
        if k == 0:
            dist0, page0_end = out.tdist, out.tpage
        page = out.tpage      # bounce waves continue in the hit's page
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
    return col, dist0, page0_end


@pytest.fixture(scope="module")
def traced(scene, jworld):
    """(d)'s 64 rays and (e)'s frame through JAX and the port."""
    froms, dirs, seeds = _portal_rays(scene.world, N)
    view = dataclasses.replace(scene, cam=portal_camera(scene))
    args = view.frame_args(0)[:4] + (SEC,)
    with ThreadPoolExecutor(2) as pool:
        jframe = pool.submit(lambda: jax.block_until_ready(
            jax_render_frame(jworld, scene.meta, scene.cfg,
                             *(jnp.asarray(a) for a in args[:4]), SEC)))
        jrays = pool.submit(lambda: jax.block_until_ready(_jax_trace(
            jworld, scene.meta, scene.cfg,
            JV3(*(jnp.asarray(froms[:, i]) for i in range(3))),
            JV3(*(jnp.asarray(dirs[:, i]) for i in range(3))),
            jnp.asarray(seeds), jnp.zeros(N, jnp.int32))))
        colj, distj, pagej = jrays.result()
        jfb, jzb = jframe.result()
    ifrom = V3(*(torch.from_numpy(froms[:, i].copy()) for i in range(3)))
    iray = V3(*(torch.from_numpy(dirs[:, i].copy()) for i in range(3)))
    colt, distt = tracer.trace_wave(
        scene.tworld, scene.cfg, ifrom, iray,
        torch.from_numpy(seeds.view(np.int32).copy()), SEC)
    tout = run_segment(scene.tworld, scene.cfg, FAST_MATH, ifrom, iray,
                       torch.ones(N, dtype=torch.bool),
                       torch.zeros(N, dtype=torch.int32))
    return dict(colj=np.stack([np.asarray(c) for c in colj], axis=1),
                distj=np.asarray(distj), pagej=np.asarray(pagej),
                colt=np.stack([c.numpy() for c in colt], axis=1),
                distt=distt.numpy(), paget=tout.tpage.numpy(),
                args=args, jfb=np.asarray(jfb), jzb=np.asarray(jzb))


def test_paged_trace_matches_jax_relaxed(traced):
    colt, colj = traced["colt"], traced["colj"]
    distt, distj = traced["distt"], traced["distj"]
    off = int((traced["pagej"] != 0).sum())
    assert off >= N // 2, f"only {off} of {N} rays left page 0"
    assert np.array_equal(traced["paget"], traced["pagej"])
    bit = ((colt.view(np.uint32) == colj.view(np.uint32)).all(axis=1)
           & (distt.view(np.uint32) == distj.view(np.uint32)))
    dc = np.abs(colt - colj).max(axis=1)
    dd = np.abs(distt - distj) / np.maximum(np.abs(distj), 1e-3)
    close = (dc <= 1e-4) & (dd <= 1e-5)
    msg = (f"{off} of {N} rays ended off page 0; {bit.mean():.3f} "
           f"bit-exact, {close.mean():.3f} within limits; max colour diff "
           f"{dc.max():.3g}, max rel distance diff {dd.max():.3g}")
    assert close.all(), msg
    assert bit.mean() >= 0.25, msg


# ---- (e) the whole frame ---------------------------------------------------

def test_paged_frame_matches_jax_relaxed(scene, traced):
    args = traced["args"]
    o, rb, rdx, rdy, _ = args
    # the primary rays' end pages, from the plain tracer
    n = W_ * H_
    rays = gen_rays(*(torch.from_numpy(v) for v in (rb, rdx, rdy)), W_, H_)
    out = run_segment(scene.tworld, scene.cfg, FAST_MATH,
                      V3(*(torch.full((n,), float(v)) for v in o)), rays,
                      torch.ones(n, dtype=torch.bool),
                      torch.zeros(n, dtype=torch.int32))
    off = float((out.tpage != scene.cfg.cam_page).float().mean())
    assert off >= 0.1, f"{off:.3f} of primary rays end off cam_page"
    before = (tracer.LAUNCHES_PAGED, blur.LAUNCHES)
    fb, zb = render_frame(scene.tworld, scene.meta, scene.cfg, *args)
    assert (tracer.LAUNCHES_PAGED, blur.LAUNCHES) == before
    fb, zb = fb.numpy().view(np.uint32), zb.numpy()
    jfb, jzb = traced["jfb"], traced["jzb"]
    bt = fb.view(np.uint8).astype(np.int32)
    bj = jfb.view(np.uint8).astype(np.int32)
    fb_bit = np.mean(fb == jfb)
    db = np.abs(bt - bj).max()
    dz_ = np.abs(zb - jzb) / np.maximum(np.abs(jzb), 1e-3)
    msg = (f"{off:.3f} of primary rays off cam_page; fb {fb_bit:.5f} "
           f"bit-exact, max byte diff {db}; zbuf max rel diff "
           f"{dz_.max():.3g}")
    assert fb_bit >= 0.999 and db <= 64, msg
    assert dz_.max() <= 1e-5, msg
    assert np.isfinite(zb).all() and len(np.unique(fb)) > 100, msg


def test_cam_page_must_be_a_page(scene):
    for page in (-1, 4):
        cfg = dataclasses.replace(scene.cfg, cam_page=page)
        with pytest.raises(ValueError, match="cam_page"):
            render_frame(scene.tworld, scene.meta, cfg,
                         *scene.frame_args(0))


def test_paged_parity_raises(scene):
    """Named for the refusal it once asserted: paged worlds in parity
    mode now render.  maze_scene(parity=True) builds the fast maze's
    world and tables, and its frame renders on the CPU through the plain
    parity tracer, with no launch; tests/test_torch_paged_parity.py
    holds the bits."""
    par = maze_scene(16, 8, "cpu", parity=True)
    assert par.cfg.parity and par.cfg.cam_page == scene.cfg.cam_page
    for f in W.WorldDev._fields:
        assert np.array_equal(np.asarray(getattr(par.world, f)),
                              np.asarray(getattr(scene.world, f))), f
    assert par.meta == scene.meta
    for f in ("ent", "word", "sph", "bound", "buckets"):
        assert torch.equal(getattr(par.tworld, f), getattr(scene.tworld, f))
    before = (tracer.LAUNCHES_PAGED, tracer.LAUNCHES_PARITY_PAGED)
    fb, zb = render_frame(par.tworld, par.meta, par.cfg, *par.frame_args(0))
    assert (tracer.LAUNCHES_PAGED, tracer.LAUNCHES_PARITY_PAGED) == before
    assert fb.shape == (8, 16) and fb.dtype == torch.int32
    assert torch.isfinite(zb).all() and torch.unique(fb).numel() > 8
