"""BASELINE config #2 (`stress`, benchmarks/configs.py:165-171) in the
port: the portal-chain level and its scene against the JAX package.

  * the port's copy of `make_portal_chain` (and `maze_text`) against the
    JAX package's (pwnfps_tpu/world/procgen.py:323-343) for 1, 8, 10 and
    11 pairs: every `LevelData` field, the level's text and the built
    world equal; numpy only;
  * 96 rays on `make_portal_chain(10)`, half of them down the chain: the
    plain parity tracer against `ScalarTracer(pinned=True)`, fb and dist
    bit for bit;
  * one fast-mode 48x27 frame of `stress_scene` (frame 0, blur off)
    against JAX `render_frame` (backend jnp), within the frame limits of
    tests/test_torch_frame.py: at least 99.9% of fb bit-exact, no byte
    off by more than 64, zbuf within 1e-5 relative.  The camera stands
    0.13 and 0.07 off the cell centre in x and z, as
    tests/test_torch_cameras.py moves its cameras: from configs.py's
    exact centre, 11 pixels of this frame aim at cell corners, where a
    1-ulp difference between XLA's and torch's rays picks the face
    (99.15% of fb bit-exact, a byte off by 178, outside the limits); off
    centre the frame is bit-exact.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pwnfps_tpu.core.approx import SseTables as RefTables
from pwnfps_tpu.ops import worlddev as RefW
from pwnfps_tpu.ops.tracer_ref import ScalarTracer, ScalarWorld
from pwnfps_tpu.render.frame import render_frame as jax_render_frame
from pwnfps_tpu.world import procgen as ref_procgen
from pwnfps_tpu.world.objects import ObjectPool as RefPool
from pwnfps_tpu_torch.core.approx import SseTables
from pwnfps_tpu_torch.ops import blur, tracer
from pwnfps_tpu_torch.ops import worlddev as W
from pwnfps_tpu_torch.render.frame import render_frame
from pwnfps_tpu_torch.scene import stress_scene
from pwnfps_tpu_torch.world.objects import ObjectPool
from pwnfps_tpu_torch.world.procgen import make_portal_chain, maze_text

from .test_torch_parity import _bits
from .test_torch_samples import _torch_rays

SEC = np.float32(0.5)
FW, FH = 48, 27


@pytest.mark.parametrize("n_pairs", [1, 8, 10, 11])
def test_portal_chain_matches_jax(n_pairs):
    lv = make_portal_chain(n_pairs)
    ref = ref_procgen.make_portal_chain(n_pairs)
    assert lv.grid.dtype == ref.grid.dtype
    assert np.array_equal(lv.grid, ref.grid)
    assert lv.spawn == ref.spawn
    assert [dataclasses.astuple(p) for p in lv.pmap] == \
        [dataclasses.astuple(p) for p in ref.pmap]
    assert maze_text(lv) == ref_procgen.maze_text(ref)
    world, meta = W.build_world(lv, ObjectPool().prepare_render(),
                                SseTables.load())
    rworld, rmeta = RefW.build_world(ref, RefPool().prepare_render(),
                                     RefTables.load())
    for f in RefW.WorldDev._fields:
        a, b = np.asarray(getattr(world, f)), np.asarray(getattr(rworld, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert dataclasses.asdict(meta) == dataclasses.asdict(rmeta)


@pytest.mark.parametrize("n_pairs", [0, 12])
def test_portal_chain_rejects_bad_length(n_pairs):
    with pytest.raises(ValueError):
        make_portal_chain(n_pairs)


def _chain_rays(n, seed0=5):
    """n rays from the corridor's floor cells (z in (1, 2)); the even
    ones start in the first two cells and head down the chain (+x) within
    0.1 rad, the odd ones start anywhere along it in any direction."""
    rng = np.random.default_rng(seed0)
    floor = [1, 2] + [x for k in range(10) for x in (5 * k + 6, 5 * k + 7)]
    froms = np.zeros((n, 4), np.float32)
    dirs = np.zeros((n, 4), np.float32)
    for k in range(n):
        cx = rng.choice([1, 2]) if k % 2 == 0 else rng.choice(floor)
        froms[k] = [cx + rng.uniform(0.05, 0.95), rng.uniform(0.1, 0.9),
                    1.0 + rng.uniform(0.05, 0.95), 1.0]
        if k % 2 == 0:
            d = np.array([1.0, *rng.normal(size=2) * 0.1])
        else:
            d = rng.normal(size=3)
        d /= np.linalg.norm(d)
        dirs[k] = [d[0], d[1] * 0.6, d[2], 0.0]
    seeds = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    return froms, dirs, seeds


def test_parity_chain_matches_scalar_spec():
    n = 96
    sc = stress_scene(8, 4, "cpu")
    froms, dirs, seeds = _chain_rays(n)
    col, dist = tracer.trace_wave(sc.tworld,
                                  dataclasses.replace(sc.cfg, parity=True),
                                  *_torch_rays(froms[:, :3], dirs[:, :3],
                                               seeds), SEC)
    colv = np.stack([c.numpy() for c in col], 1)
    distv = dist.numpy()
    sw = ScalarWorld(ref_procgen.make_portal_chain(10),
                     RefPool().prepare_render(), RefTables.load())
    bad = []
    for k in range(n):
        tr = ScalarTracer(sw, sec_current=SEC, pinned=True)
        c, d, _ = tr.trace(froms[k], dirs[k], int(seeds[k]))
        if not (np.array_equal(_bits(colv[k]), _bits(c))
                and _bits(distv[k]) == _bits(d)):
            bad.append((k, colv[k], c, distv[k], d))
    assert not bad, f"{len(bad)} of {n} rays differ, first {bad[:2]}"
    # the chain rays travel through the portals: past the first pair's
    # far cell (x = 5) before they hit a wall
    far = (froms[0::2, 0] + distv[0::2] * dirs[0::2, 0]) > 6.0
    assert far.mean() > 0.5, far.mean()


def test_stress_frame_matches_jax_relaxed():
    sc = stress_scene(FW, FH, "cpu", postproc_blur=0)
    sc.cam[3, 0] += 0.13
    sc.cam[3, 2] += 0.07
    args = sc.frame_args(0)
    before = (tracer.LAUNCHES, blur.LAUNCHES)
    fb, zb = render_frame(sc.tworld, sc.meta, sc.cfg, *args)
    assert (tracer.LAUNCHES, blur.LAUNCHES) == before   # CPU: plain
    jfb, jzb = jax_render_frame(jax.tree.map(jnp.asarray, sc.world),
                                sc.meta, sc.cfg,
                                *(jnp.asarray(a) for a in args[:4]), args[4])
    fb, zb = fb.numpy().view(np.uint32), zb.numpy()
    jfb, jzb = np.asarray(jfb), np.asarray(jzb)
    bt = fb.view(np.uint8).astype(np.int32)
    bj = jfb.view(np.uint8).astype(np.int32)
    fb_bit = np.mean(fb == jfb)
    db = np.abs(bt - bj).max()
    dz = np.abs(zb - jzb) / np.maximum(np.abs(jzb), 1e-3)
    msg = (f"fb {fb_bit:.5f} bit-exact, max byte diff {db}; zbuf max rel "
           f"diff {dz.max():.3g}")
    assert fb.shape == (FH, FW)
    assert fb_bit >= 0.999 and db <= 64, msg
    assert dz.max() <= 1e-5, msg
    assert np.isfinite(zb).all() and len(np.unique(fb)) > 100, msg
