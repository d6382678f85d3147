"""The port's single-device camera batch (BASELINE config #4) and its
per-camera blur against the JAX package.

(a) `parallel.sharding.render_cameras` at C=4, 32x24, blur off, against
    the JAX package's `render_cameras` on a 1x1 mesh (backend jnp),
    within the fast-mode frame limits of tests/test_torch_frame.py for
    each camera;
(b) the batched plain blur (`dof_blur` with `frame_h`) on 4 stacked
    24-row frames equals `dof_blur_plain` of each frame alone and JAX
    `jax.vmap(dof_blur)` of the same frames, bit for bit (the blur is
    exact against JAX);
(c) parity mode raises ValueError, as in the JAX package.

The cameras of (a) stand 0.13 and 0.07 off the spawn cell's centre in x
and z: from the centre, a pixel of camera 0's 32x24 grid has the exact
direction (0.5625, -0.0625, 1) and meets a cell corner exactly, where a
1-ulp difference between XLA's and torch's normalised ray picks the
face (tests/test_torch_paged.py moves its cameras off centre for the
same reason).

The two JAX compiles (the camera batch and the vmapped blur) run in two
threads."""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pwnfps_tpu.ops.blur import dof_blur as jax_dof_blur
from pwnfps_tpu.parallel.sharding import make_mesh
from pwnfps_tpu.parallel.sharding import render_cameras as jax_cameras
from pwnfps_tpu_torch.ops import blur, tracer
from pwnfps_tpu_torch.parallel.sharding import _render_cams, render_cameras
from pwnfps_tpu_torch.render.frame import pixel_seeds
from pwnfps_tpu_torch.scene import multicam_scene

C, W_, H_ = 4, 32, 24
STEP = 3


def _random_frames(c, h, w, seed):
    rng = np.random.default_rng(seed)
    fb = rng.integers(0, 2 ** 32, (c * h, w), dtype=np.uint64)
    z = rng.uniform(-0.5, 40.0, (c * h, w)).astype(np.float32)
    for val in (1e30, -1e30, np.nan):
        z[rng.random((c * h, w)) < 0.02] = val
    return fb.astype(np.uint32), z


@pytest.fixture(scope="module")
def batch():
    """The camera batch through JAX and the port, and the traced frames
    (blur off) the blur tests take."""
    sc = multicam_scene("cpu", n_cams=C, width=W_, height=H_)
    cams, sec = sc.step_args(STEP)
    cams = cams.copy()
    cams[:, 3, 0] += 0.13
    cams[:, 3, 2] += 0.07
    world = jax.tree.map(jnp.asarray, sc.world)
    mesh = make_mesh(1, 1, jax.devices()[:1])
    # the port's own traced frames and their zbuf, for (b)
    fb_t, zb_t = _render_cams(sc.tworld, sc.cfg, torch.from_numpy(cams),
                              pixel_seeds(W_, H_, "cpu"), sec)
    frames = {"traced": (fb_t.reshape(C * H_, W_).numpy().view(np.uint32),
                         zb_t.reshape(C * H_, W_).numpy()),
              "random": _random_frames(C, H_, 37, 7)}
    vblur = jax.jit(jax.vmap(lambda f, z: jax_dof_blur(f, z, 2)))
    with ThreadPoolExecutor(2) as pool:
        jfb = pool.submit(lambda: np.asarray(jax_cameras(
            world, sc.meta, sc.cfg, cams, sec, mesh)))
        jblur = {k: pool.submit(lambda f=f, z=z: np.asarray(vblur(
            jnp.asarray(f.reshape(C, H_, -1)),
            jnp.asarray(z.reshape(C, H_, -1)))))
            for k, (f, z) in frames.items()}
        before = (tracer.LAUNCHES, blur.LAUNCHES)
        fb = render_cameras(sc.tworld, sc.meta, sc.cfg, cams, sec)
        launches = (tracer.LAUNCHES - before[0], blur.LAUNCHES - before[1])
        return dict(scene=sc, fb=fb, jfb=jfb.result(), frames=frames,
                    jblur={k: v.result() for k, v in jblur.items()},
                    launches=launches)


def test_render_cameras_matches_jax_relaxed(batch):
    fb = batch["fb"]
    assert fb.shape == (C, H_, W_) and fb.dtype == torch.int32
    assert batch["launches"] == (0, 0)        # CPU tensors: plain versions
    fb = fb.numpy().view(np.uint32)
    jfb = batch["jfb"]
    assert jfb.shape == (C, H_, W_)
    for c in range(C):
        bt = fb[c].view(np.uint8).astype(np.int32)
        bj = jfb[c].view(np.uint8).astype(np.int32)
        fb_bit = np.mean(fb[c] == jfb[c])
        db = np.abs(bt - bj).max()
        msg = f"camera {c}: fb {fb_bit:.5f} bit-exact, max byte diff {db}"
        assert fb_bit >= 0.999 and db <= 64, msg
        assert len(np.unique(fb[c])) > 50, msg
    # the cameras look different ways
    assert len({fb[c].tobytes() for c in range(C)}) == C


@pytest.mark.parametrize("kind", ["traced", "random"])
def test_batched_blur_equals_each_frame_and_jax(batch, kind):
    f, z = batch["frames"][kind]
    fb = torch.from_numpy(f.view(np.int32).copy())
    zb = torch.from_numpy(z.copy())
    got = blur.dof_blur(fb, zb, 2, frame_h=H_)
    assert got.shape == fb.shape
    each = torch.cat([blur.dof_blur_plain(fb[k * H_:(k + 1) * H_],
                                          zb[k * H_:(k + 1) * H_], 2)
                      for k in range(C)])
    assert torch.equal(got, each)
    # the [C, h, w] form blurs each frame the same way
    got3 = blur.dof_blur(fb.view(C, H_, -1), zb.view(C, H_, -1), 2)
    assert torch.equal(got3.reshape(fb.shape), got)
    want = batch["jblur"][kind].reshape(f.shape)
    assert np.array_equal(got.numpy().view(np.uint32), want)
    # blurring the stack as one frame would differ
    assert not torch.equal(blur.dof_blur(fb, zb, 2), got)


def test_bad_frame_height_raises():
    fb = torch.zeros((48, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="frame_h"):
        blur.dof_blur(fb, torch.zeros((48, 8)), frame_h=20)
    with pytest.raises(ValueError, match="frame_h"):
        blur.dof_blur(fb.view(2, 24, 8), torch.zeros((2, 24, 8)), frame_h=12)


def test_render_cameras_parity_raises(batch):
    sc = batch["scene"]
    cfg = dataclasses.replace(sc.cfg, parity=True)
    cams, sec = sc.step_args(0)
    with pytest.raises(ValueError, match="fast-mode only"):
        render_cameras(sc.tworld, sc.meta, cfg, cams, sec)
