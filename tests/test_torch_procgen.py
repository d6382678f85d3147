"""The port's cave level generator (pwnfps_tpu_torch/world/procgen.py
`_cave_grid`, `generate_maze`) against the JAX package's.

  * `_cave_grid` on the CPU equals JAX's cell for cell for seeds 0, 5,
    11, 12345, 2^31 + 5 and 2^32 + 7: the port's numpy Threefry-2x32
    gives the bits of `jax.random.uniform(jax.random.PRNGKey(seed),
    (64, 64))` (32-bit mode keeps the seed's low word: 2^32 + 7 draws
    seed 7's grid), and the smoothing passes run as int32 torch ops;
  * `generate_maze` gives a LevelData equal field by field (grid,
    spawn, every portal slot) to JAX's for seeds 5 and 11, with the
    defaults and with fog, tall, ramps off and no lowercase portals;
  * a 32x24 fast frame of the seed-11 level (`scene.cave_scene`, no
    spheres, one DoF pass) from the port's plain tracer agrees with JAX
    `render_frame` (backend jnp) within the fast-frame limits of
    tests/test_torch_frame.py, the camera 0.13/0.07 off the spawn cell's
    centre (tests/test_torch_cameras.py says why)."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pwnfps_tpu.render.frame import render_frame as jax_render_frame
from pwnfps_tpu.world import procgen as jax_procgen
from pwnfps_tpu_torch.render.frame import render_frame
from pwnfps_tpu_torch.scene import cave_scene
from pwnfps_tpu_torch.world import procgen

SEEDS = (0, 5, 11, 12345, 2 ** 31 + 5, 2 ** 32 + 7)
W, H = 64, 48
OFF = (0.13, 0.07)          # camera offset from the cell centre, x and z


@pytest.mark.parametrize("seed", SEEDS)
def test_cave_grid_matches_jax(seed):
    got = procgen._cave_grid(seed, 0.44, 4, device="cpu")
    want = jax_procgen._cave_grid(seed, 0.44, 4)
    assert got.dtype == np.bool_ and got.shape == (64, 64)
    assert np.array_equal(got, want), f"{int((got != want).sum())} cells"


def test_threefry_uniform_matches_jax():
    for seed in (3, 2 ** 32 - 1):
        got = procgen._threefry_uniform(seed, (5, 7))
        want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed),
                                             (5, 7)))
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("seed", (5, 11))
@pytest.mark.parametrize("kw", [
    {}, dict(fog=False, tall=False, ramps=False, lowercase=0)],
    ids=("defaults", "plain"))
def test_generate_maze_matches_jax(seed, kw):
    got = procgen.generate_maze(seed, device="cpu", **kw)
    want = jax_procgen.generate_maze(seed, **kw)
    assert np.array_equal(got.grid, want.grid)
    assert tuple(got.spawn) == tuple(want.spawn)
    assert [dataclasses.asdict(p) for p in got.pmap] == \
        [dataclasses.asdict(p) for p in want.pmap]
    assert sum(p.open for p in got.pmap) >= 16 or kw


def test_cave_frame_matches_jax():
    sc = cave_scene(11, W, H, "cpu")
    sc.cam[3, 0] += OFF[0]
    sc.cam[3, 2] += OFF[1]
    args = sc.frame_args(0)
    fb, zb = render_frame(sc.tworld, sc.meta, sc.cfg, *args)
    world = jax.tree.map(jnp.asarray, sc.world)
    jfb, jzb = jax_render_frame(world, sc.meta, sc.cfg,
                                *(jnp.asarray(a) for a in args[:4]),
                                args[4])
    fb = fb.numpy().view(np.uint32)
    zb = zb.numpy()
    jfb, jzb = np.asarray(jfb), np.asarray(jzb)
    bt = fb.view(np.uint8).reshape(H, W, 4).astype(np.int32)
    bj = jfb.view(np.uint8).reshape(H, W, 4).astype(np.int32)
    fb_bit = np.mean(fb == jfb)
    z_bit = np.mean(zb.view(np.uint32) == jzb.view(np.uint32))
    db = np.abs(bt - bj).max()
    dz = np.abs(zb - jzb) / np.maximum(np.abs(jzb), 1e-3)
    msg = (f"fb {fb_bit:.5f} bit-exact, max byte diff {db}; zbuf "
           f"{z_bit:.3f} bit-exact, max rel diff {dz.max():.3g}")
    assert len(np.unique(fb)) > 50, msg          # not a flat frame
    assert fb_bit >= 0.999 and db <= 64, msg
    assert dz.max() <= 1e-5 and z_bit >= 0.5, msg
