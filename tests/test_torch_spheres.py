"""Worlds of 17 to 64 spheres in the port, on the CPU.

The JAX package renders up to 64 spheres (world/objects.py NS_MAX; its
jnp backend, the default, traces them all), and so does the port.  The
input is ROADMAP's: the demo level with spheres of radius 0.05 at (2.5 +
k%5, 0.3, 3.5 + k//5), k = 0..19, extended to 64 in open cells of the
same room (POSITIONS); the camera at the spawn point, sec 0, the pixel
seeds.  Checked:

  * fast mode, 32x24, one DoF pass, at 64 spheres: the port's
    `render_frame` against the JAX package's (backend jnp), bit for bit
    in fb and zbuf, with XLA:CPU's rsqrt, sqrt, sin, cos and exp in the
    port's plain tracer (`tracer_core.FAST_MATH`).  Those functions are
    the whole gap between the two: XLA:CPU's rsqrt differs from torch's
    on the CPU by up to 2 ulp (on 29% of inputs), its sqrt on 0.7%, and
    the reference's sphere distance, sqrt(dist2) - sqrt(1 - calcrad2 /
    r^2), multiplies such a difference by up to 1/r^2 = 400 for these
    spheres near a grazing hit.  With torch's functions the frame
    misses the frame limits of tests/test_torch_frame.py (measured: fb
    767 of 768 pixels bit-exact, zbuf within 2.9e-4 relative, the same
    at 14 and at 20 of these spheres).  JAX runs op by op
    (`jax.disable_jit`), ~25 s: its jnp backend unrolls the sphere loop
    at every call site, and XLA:CPU's compile of the 64-sphere frame
    takes minutes and gigabytes;
  * parity mode, 16x12 without blur, at 20 spheres: fb and zbuf bit for
    bit against a frame built pixel by pixel from the scalar spec
    `ScalarTracer(pinned=True)` on the same rays and seeds;
  * `world_to_torch` refuses 65 spheres.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pwnfps_tpu.core import lcg as ref_lcg
from pwnfps_tpu.core.approx import SseTables as RefTables
from pwnfps_tpu.core.config import RenderConfig as RefConfig
from pwnfps_tpu.ops import worlddev as RefW
from pwnfps_tpu.ops.tracer_ref import ScalarTracer, ScalarWorld
from pwnfps_tpu.render.frame import render_frame as jax_render_frame
from pwnfps_tpu.world.levelc import load_level as ref_load_level
from pwnfps_tpu.world.objects import ObjectPool as RefPool
from pwnfps_tpu_torch.ops import tracer_core
from pwnfps_tpu_torch.ops.world import NSPH_MAX, world_to_torch
from pwnfps_tpu_torch.render.frame import render_frame
from pwnfps_tpu_torch.scene import LEVEL, sphere_grid, spheres_scene

# sphere k's centre: ROADMAP's 20, then the same 5x4 cells at y 0.7 and
# offset by (0.25, 0.5, 0.25) (20 each), then four in column x 1.5
POSITIONS = ([(2.5 + k % 5, 0.3, 3.5 + k // 5) for k in range(20)]
             + [(2.5 + k % 5, 0.7, 3.5 + k // 5) for k in range(20)]
             + [(2.75 + k % 5, 0.5, 3.75 + k // 5) for k in range(20)]
             + [(1.5, 0.3, 3.5 + k) for k in range(4)])


def _ref_world(n):
    """The JAX package's world of the first n spheres of sphere_grid."""
    pool = RefPool()
    for (x, y, z, r, b, g, rr, refl) in sphere_grid(n):
        pool.obj_set_sphere(pool.obj_new(), r, refl, x, y, z, b, g, rr)
    lv = ref_load_level(LEVEL)
    sph = pool.prepare_render()
    return lv, sph, RefW.build_world(lv, sph, RefTables.load())


def test_positions_are_the_scenes():
    grid = sphere_grid(64)
    assert [s[:3] for s in grid] == POSITIONS
    assert all(s[3] == 0.05 for s in grid)
    assert NSPH_MAX == 64


def _xla(fn):
    """fn of jax.numpy on a CPU tensor, as a tensor."""
    return lambda x: torch.from_numpy(np.array(fn(jnp.asarray(x.numpy()))))


def test_fast_frame_matches_jax(monkeypatch):
    n = 64
    monkeypatch.setattr(tracer_core, "FAST_MATH", tracer_core.Math(
        rsq=_xla(jax.lax.rsqrt), rcp=lambda x: 1.0 / x,
        div=lambda a, b: a / b, sqrt=_xla(jnp.sqrt), sin=_xla(jnp.sin),
        cos=_xla(jnp.cos), exp=_xla(jnp.exp)))
    sc = spheres_scene(n, 32, 24, "cpu")
    assert sc.tworld.n_spheres == n
    args = sc.frame_args(0)
    fb, zb = render_frame(sc.tworld, sc.meta, sc.cfg, *args)
    _, _, (world, meta) = _ref_world(n)
    assert meta.n_spheres == n
    cfg = RefConfig(width=32, height=24, parity=False)
    with jax.disable_jit():
        jfb, jzb = jax_render_frame(world, meta, cfg,
                                    *(jnp.asarray(a) for a in args[:4]),
                                    args[4])
    fb = fb.numpy().view(np.uint32)
    jfb = np.asarray(jfb)
    assert np.array_equal(fb, jfb), f"{(fb != jfb).sum()} pixels differ"
    assert np.array_equal(zb.numpy().view(np.uint32),
                          np.asarray(jzb).view(np.uint32))
    assert len(np.unique(fb)) > 100          # not a flat frame


def test_parity_frame_matches_scalar_spec():
    fw, fh = 16, 12
    sc = spheres_scene(20, fw, fh, "cpu", parity=True, postproc_blur=0)
    origin, rayb, rdx, rdy, sec = sc.frame_args(0)
    fb, zb = render_frame(sc.tworld, sc.meta, sc.cfg, origin, rayb, rdx,
                          rdy, sec)
    lv, sph, _ = _ref_world(20)
    sw = ScalarWorld(lv, sph, RefTables.load())
    # the parity rays: each 32-pixel tile of a row accumulates rdx from
    # (rayb + y*rdy) + x0*rdx (screen.h:12-24); one tile a row here
    xs = np.arange(fw, dtype=np.uint32)
    ys = np.arange(fh, dtype=np.uint32)
    seeds = ref_lcg.pixel_seed(xs[None, :], ys[:, None], fw).reshape(-1)
    frm = np.array([*origin, 1.0], np.float32)
    want_fb = np.zeros(fw * fh, np.uint32)
    want_zb = np.zeros(fw * fh, np.float32)
    for y in range(fh):
        acc = rayb + np.float32(y) * rdy
        for x in range(fw):
            acc = acc + rdx
            i = y * fw + x
            tr = ScalarTracer(sw, sec_current=sec, pinned=True)
            c, want_zb[i], _ = tr.trace(
                frm, np.array([*acc, 0.0], np.float32), int(seeds[i]))
            # util.h:48-59 pack: round half to even, clamp to 0..255
            q = np.clip(np.rint(c * np.float32(255.0)), 0, 255)
            q = q.astype(np.uint32)
            want_fb[i] = q[0] | (q[1] << 8) | (q[2] << 16) | (q[3] << 24)
    got_fb = fb.numpy().view(np.uint32).reshape(-1)
    assert np.array_equal(got_fb, want_fb), \
        f"{(got_fb != want_fb).sum()} pixels differ"
    assert np.array_equal(zb.numpy().view(np.uint32).reshape(-1),
                          want_zb.view(np.uint32))
    assert len(np.unique(got_fb)) > 50


def test_world_to_torch_refuses_65_spheres():
    sc = spheres_scene(64, 8, 8, "cpu")
    w = sc.world
    world = w._replace(
        sph_pos=np.concatenate([w.sph_pos, [[4.5, 0.3, 4.5]]]).astype(
            np.float32),
        sph_r=np.append(w.sph_r, np.float32(0.05)),
        sph_refl=np.append(w.sph_refl, np.float32(0.2)),
        sph_col=np.concatenate([w.sph_col, [[0.5, 0.5, 0.5]]]).astype(
            np.float32))
    meta = dataclasses.replace(sc.meta, n_spheres=65)
    with pytest.raises(ValueError, match="65 spheres exceed the "
                                         "64-sphere cap"):
        world_to_torch(world, meta, "cpu")
