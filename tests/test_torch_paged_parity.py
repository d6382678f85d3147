"""Paged worlds in parity mode (the maze's pixel-exact frames) in the
port, on the CPU.

There is no paged scalar specification.  Paging adds three things to the
one-page parity semantics: page offsets into the tables, the page jump
at a portal (word bits 26-29), and spheres on `sphere_page` only.  Each
is held bit for bit against `ScalarTracer(pinned=True)` by construction,
on atlases built from one level's `pack_static_word` pages with the
target pages set here:

  (a) offsets and the sphere page: page 0 is another level (the
      three-pair portal chain), page 1 the demo level with every
      portal's target page 1, the creature on page 1 and the camera on
      page 1.  The 32x24 parity frame equals, in every fb and zbuf bit,
      the frame tests/test_torch_parity.py builds from the scalar spec
      on the one-page demo level.  No bucket of the creature lands on a
      portal cell, so `build_world_paged` takes it where it stands;
  (b) cross-page portals: `make_portal_chain(10)`, no spheres, on three
      identical pages, each portal of page p leading to page (p+1) % 3;
      96 rays from page 0 (half down the chain) equal the scalar spec on
      the one-page chain, and at least 10% of their primary segments end
      off page 0;
  (c) the real maze: a 24x16 parity frame of `maze_scene` (BASELINE
      config #3 in parity mode) from the portal camera, blur off,
      against JAX `render_frame(parity=True, backend="jnp")`: bit-equal
      where XLA does not contract FMAs (tests/fputil.fma_contracts);
      where it does, within tests/test_torch_frame.py's frame limits (at
      least 99.9% of fb bit-exact, no byte off by more than 64, zbuf
      within 1e-5 relative).  Here XLA contracts them, and the zbuf of 7
      of the 384 pixels lies outside the limits (fb is bit-exact): the
      test is a strict xfail that records the gap, ROADMAP.md section 3.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pwnfps_tpu.core.approx import SseTables as RefTables
from pwnfps_tpu.ops.tracer_ref import ScalarTracer, ScalarWorld
from pwnfps_tpu.render.frame import render_frame as jax_render_frame
from pwnfps_tpu.world import procgen as ref_procgen
from pwnfps_tpu.world.objects import ObjectPool as RefPool
from pwnfps_tpu_torch.core.approx import SseTables
from pwnfps_tpu_torch.core.config import RenderConfig
from pwnfps_tpu_torch.ops import tracer
from pwnfps_tpu_torch.ops import worlddev as W
from pwnfps_tpu_torch.ops.tracer_core import make_math, run_segment
from pwnfps_tpu_torch.ops.world import world_to_torch
from pwnfps_tpu_torch.render.frame import render_frame
from pwnfps_tpu_torch.scene import (LEVEL, creature_pool, maze_scene,
                                    portal_camera, ring_scene, with_dpage)
from pwnfps_tpu_torch.world.levelc import load_level
from pwnfps_tpu_torch.world.procgen import make_portal_chain

from .fputil import fma_contracts
from .test_torch_parity import _bits, frame_pair  # noqa: F401 (fixture)
from .test_torch_samples import _torch_rays
from .test_torch_stress import SEC as CHAIN_SEC
from .test_torch_stress import _chain_rays


def _launches():
    return (tracer.LAUNCHES, tracer.LAUNCHES_PAGED, tracer.LAUNCHES_PARITY,
            tracer.LAUNCHES_PARITY_PAGED)


def test_sphere_page_offsets_match_scalar_spec(frame_pair):  # noqa: F811
    demo = W.pack_static_word(load_level(LEVEL))
    other = W.pack_static_word(make_portal_chain(3))
    world, meta = W.build_world_paged(np.stack([other, with_dpage(demo, 1)]),
                                      creature_pool().prepare_render(), 1,
                                      SseTables.load())
    wt = world_to_torch(world, meta, "cpu")
    # the tables build_world_paged lays out: the creature's buckets on
    # page 1 only, -1 and count 0 on page 0
    kb = np.asarray(world.buckets).reshape(2, 4096, -1)
    assert (kb[0] == -1).all() and (kb[1] >= 0).any()
    assert (wt.ent.view(2, 4096)[0] >> 15 == 0).all()
    assert int((wt.ent.view(2, 4096)[1] >> 15).max()) > 0
    assert wt.buckets.shape == (2 * 4096 * meta.k_bucket,)
    cfg = dataclasses.replace(frame_pair["sc"].cfg, cam_page=1)
    before = _launches()
    fb, zb = render_frame(wt, meta, cfg, *frame_pair["args"])
    assert _launches() == before                 # CPU: the plain tracer
    fb = fb.numpy().view(np.uint32)
    assert np.array_equal(fb, frame_pair["ref_fb"]), \
        f"{(fb != frame_pair['ref_fb']).sum()} pixels differ"
    assert np.array_equal(_bits(zb.numpy()), _bits(frame_pair["ref_zb"]))


def test_cross_page_portals_match_scalar_spec():
    wt = ring_scene(8, 4, "cpu").tworld
    assert wt.n_pages == 3
    n = 96
    froms, dirs, seeds = _chain_rays(n)
    cfg = RenderConfig(parity=True)
    ifrom, iray, seed_t = _torch_rays(froms[:, :3], dirs[:, :3], seeds)
    col, dist = tracer.trace_wave(wt, cfg, ifrom, iray, seed_t, CHAIN_SEC)
    colv = np.stack([c.numpy() for c in col], 1)
    distv = dist.numpy()
    sw = ScalarWorld(ref_procgen.make_portal_chain(10),
                     RefPool().prepare_render(), RefTables.load())
    bad = []
    for k in range(n):
        tr = ScalarTracer(sw, sec_current=CHAIN_SEC, pinned=True)
        c, d, _ = tr.trace(froms[k], dirs[k], int(seeds[k]))
        if not (np.array_equal(_bits(colv[k]), _bits(c))
                and _bits(distv[k]) == _bits(d)):
            bad.append((k, colv[k], c, distv[k], d))
    assert not bad, f"{len(bad)} of {n} rays differ, first {bad[:2]}"
    out = run_segment(wt, cfg, make_math(wt, True), ifrom, iray,
                      torch.ones(n, dtype=torch.bool),
                      torch.zeros(n, dtype=torch.int32))
    off = float((out.tpage != 0).float().mean())
    assert off >= 0.1, f"{off:.3f} of primary segments end off page 0"


@pytest.fixture(scope="module")
def maze_frames():
    """The port's and JAX's 24x16 parity frames of the maze from the
    portal camera, blur off."""
    sc = maze_scene(24, 16, "cpu", parity=True, postproc_blur=0)
    sc.cam = portal_camera(sc)
    args = sc.frame_args(0)
    before = _launches()
    fb, zb = render_frame(sc.tworld, sc.meta, sc.cfg, *args)
    launches = tuple(a - b for a, b in zip(_launches(), before))
    jfb, jzb = jax_render_frame(jax.tree.map(jnp.asarray, sc.world),
                                sc.meta, sc.cfg,
                                *(jnp.asarray(a) for a in args[:4]), args[4])
    return dict(fb=fb.numpy().view(np.uint32), zb=zb.numpy(),
                jfb=np.asarray(jfb), jzb=np.asarray(jzb), launches=launches)


@pytest.mark.xfail(strict=True, reason=(
    "zbuf outside the frame limits against the jitted JAX frame: 7 of 384 "
    "pixels, first (x 10, y 12) 0x3fcb0800 (port) against 0x3fcaf000 "
    "(JAX), 4.6e-4 relative; fb bit-exact.  XLA:CPU contracts multiply-"
    "adds inside the jitted trace, which moves an SSE-table rsqrt/rcp "
    "lookup to its neighbouring bin (2^-12 relative); JAX's own "
    "segment_body run op by op gives the port's bits (ROADMAP.md section "
    "3)"))
def test_maze_parity_frame_matches_jax(maze_frames):
    fb, zb = maze_frames["fb"], maze_frames["zb"]
    jfb, jzb = maze_frames["jfb"], maze_frames["jzb"]
    assert fb.shape == (16, 24) and maze_frames["launches"] == (0, 0, 0, 0)
    assert np.isfinite(zb).all() and len(np.unique(fb)) > 50
    if not fma_contracts():
        assert np.array_equal(fb, jfb)
        assert np.array_equal(_bits(zb), _bits(jzb))
        return
    bt = fb.view(np.uint8).astype(np.int32)
    bj = jfb.view(np.uint8).astype(np.int32)
    fb_bit = np.mean(fb == jfb)
    db = np.abs(bt - bj).max()
    dz = np.abs(zb - jzb) / np.maximum(np.abs(jzb), 1e-3)
    msg = (f"fb {fb_bit:.5f} bit-exact, max byte diff {db}; zbuf max rel "
           f"diff {dz.max():.3g}")
    assert fb_bit >= 0.999 and db <= 64, msg
    assert dz.max() <= 1e-5, msg
