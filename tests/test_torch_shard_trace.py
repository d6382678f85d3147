"""The port's `parallel.sharding.shard_trace` (the JAX package's public
flat-batch trace over every mesh axis, pwnfps_tpu/parallel/sharding.py:
63-79) on a mesh of `["cpu"] * 8`, (cam, px) = (2, 4).

  * the parts, concatenated in mesh order, are bit-equal to
    `trace_wave(pack=True)` on the whole batch, in fast and parity mode,
    part k holding rays [k * N / 8, (k + 1) * N / 8) on mesh.flat[k];
  * the fast result agrees with JAX's `shard_trace` (backend jnp) on its
    8 virtual CPU devices within the fast-mode limits of
    tests/test_torch_tracer.py, packed: every BGRA byte within one (a
    colour within 1e-4 rounds to a neighbouring byte at most), zbuf
    within 1e-5 relative, at least a quarter of the rays bit-exact;
  * a batch that does not split over the mesh raises ValueError.

The rays are tests/test_torch_tracer.py's random rays over the demo
level with a 3-sphere scene."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pwnfps_tpu.ops.vec import V3 as JV3
from pwnfps_tpu.parallel.sharding import make_mesh as jax_make_mesh
from pwnfps_tpu.parallel.sharding import shard_trace as jax_shard_trace
from pwnfps_tpu_torch.ops import tracer
from pwnfps_tpu_torch.ops.vec import V3
from pwnfps_tpu_torch.parallel import sharding as S
from pwnfps_tpu_torch.scene import flagship_scene, parity_scene

from .test_torch_tracer import _rays

N = 256
SEC = np.float32(2.5)
MESH = S.make_mesh(2, 4, ["cpu"] * 8)


@pytest.fixture(scope="module")
def batch():
    froms, dirs, seeds = _rays(N, seed0=23)
    ifrom = V3(*(torch.from_numpy(froms[:, i].copy()) for i in range(3)))
    iray = V3(*(torch.from_numpy(dirs[:, i].copy()) for i in range(3)))
    return (froms, dirs, seeds), ifrom, iray, torch.from_numpy(
        seeds.view(np.int32).copy())


@pytest.mark.parametrize("parity", [False, True], ids=["fast", "parity"])
def test_parts_equal_trace_wave(batch, parity):
    _, ifrom, iray, seeds = batch
    make = parity_scene if parity else flagship_scene
    sc = make(32, 8, "cpu", n_spheres=3, maxsteps=300)
    before = tracer.LAUNCHES
    fbs, zbs = S.shard_trace(sc.world, sc.meta, sc.cfg, MESH, ifrom, iray,
                             seeds, SEC)
    assert tracer.LAUNCHES == before             # the CPU runs no kernel
    assert len(fbs) == len(zbs) == MESH.size
    for k, (f, z) in enumerate(zip(fbs, zbs)):
        assert f.shape == z.shape == (N // MESH.size,)
        assert f.dtype == torch.int32 and z.dtype == torch.float32
        assert f.device == z.device == MESH.flat[k]
    fb, zb = tracer.trace_wave(sc.tworld, sc.cfg, ifrom, iray, seeds, SEC,
                               pack=True)
    assert torch.equal(torch.cat(fbs), fb)
    assert torch.equal(torch.cat(zbs).view(torch.int32),
                       zb.view(torch.int32))


def test_fast_matches_jax_shard_trace(batch):
    (froms, dirs, seeds), ifrom, iray, seed_t = batch
    sc = flagship_scene(32, 8, "cpu", n_spheres=3, maxsteps=300)
    fbs, zbs = S.shard_trace(S.replicate_world(sc.world, sc.meta, MESH),
                             None, sc.cfg, MESH, ifrom, iray, seed_t, SEC)
    fb = torch.cat(fbs).numpy().view(np.uint32)
    zb = torch.cat(zbs).numpy()
    world = jax.tree.map(jnp.asarray, sc.world)
    jmesh = jax_make_mesh(2, 4, jax.devices()[:8])
    jfb, jzb = jax.jit(
        lambda *a: jax_shard_trace(world, sc.meta, sc.cfg, jmesh,
                                   JV3(*a[:3]), JV3(*a[3:6]), a[6], SEC)
    )(*(jnp.asarray(froms[:, i]) for i in range(3)),
      *(jnp.asarray(dirs[:, i]) for i in range(3)), jnp.asarray(seeds))
    jfb, jzb = np.asarray(jfb), np.asarray(jzb)
    db = np.abs(fb.view(np.uint8).reshape(N, 4).astype(np.int32)
                - jfb.view(np.uint8).reshape(N, 4).astype(np.int32))
    dz = np.abs(zb - jzb) / np.maximum(np.abs(jzb), 1e-3)
    bit = (fb == jfb) & (zb.view(np.uint32) == jzb.view(np.uint32))
    msg = (f"{bit.mean():.3f} of {N} rays bit-exact; max byte diff "
           f"{db.max()}, max rel zbuf diff {dz.max():.3g}")
    assert db.max() <= 1 and dz.max() <= 1e-5, msg
    assert bit.mean() >= 0.25, msg


def test_batch_that_does_not_split_raises(batch):
    _, ifrom, iray, seeds = batch
    sc = flagship_scene(32, 8, "cpu", n_spheres=3, maxsteps=64)
    cut = V3(*(t[:N - 3] for t in ifrom)), V3(*(t[:N - 3] for t in iray))
    with pytest.raises(ValueError, match="split"):
        S.shard_trace(sc.world, sc.meta, sc.cfg, MESH, *cut,
                      seeds[:N - 3], SEC)
    with pytest.raises(ValueError):
        S.shard_trace(sc.world, sc.meta, sc.cfg,
                      S.make_mesh(1, 3, ["cpu"] * 3), ifrom, iray, seeds,
                      SEC)
