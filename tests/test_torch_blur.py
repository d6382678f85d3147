"""The port's plain DoF pass (pwnfps_tpu_torch/ops/blur.py) against the
JAX package's `dof_blur` and the serial numpy reference, bit for bit.

Includes w % 4 != 0 and +-1e30 / NaN depths, which pin the saturating
float-to-int conversion of the tap coordinates."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pwnfps_tpu.ops.blur import dof_blur as jax_dof_blur
from pwnfps_tpu_torch.ops import blur

from .test_blur import numpy_blur_reference


def _inputs(h, w, seed, extremes):
    rng = np.random.default_rng(seed)
    fb = rng.integers(0, 2 ** 32, (h, w), dtype=np.uint64).astype(np.uint32)
    z = rng.uniform(-0.5, 40.0, (h, w)).astype(np.float32)
    for val in extremes:
        z[rng.random((h, w)) < 0.05] = val
    return fb, z


def _torch_blur(fb, z, passes=1):
    out = blur.dof_blur(torch.from_numpy(fb.view(np.int32).copy()),
                        torch.from_numpy(z), passes)
    assert out.dtype == torch.int32
    return out.numpy().view(np.uint32)


@pytest.mark.parametrize("h,w", [(24, 36), (48, 64), (37, 100)])
def test_blur_matches_jax_and_numpy(h, w):
    fb, z = _inputs(h, w, seed=h * w, extremes=(1e30, -1e30))
    got = _torch_blur(fb, z)
    assert np.array_equal(got, np.asarray(jax_dof_blur(jnp.asarray(fb),
                                                       jnp.asarray(z))))
    assert np.array_equal(got, numpy_blur_reference(fb, z))


def test_blur_nan_depth_and_two_passes():
    fb, z = _inputs(40, 52, seed=3, extremes=(1e30, -1e30, np.nan,
                                               np.inf))
    for passes in (1, 2):
        want = np.asarray(jax_dof_blur(jnp.asarray(fb), jnp.asarray(z),
                                       passes))
        assert np.array_equal(_torch_blur(fb, z, passes), want)


def test_blur_cpu_does_not_launch():
    fb, z = _inputs(8, 12, seed=1, extremes=())
    before = blur.LAUNCHES
    _torch_blur(fb, z)
    assert blur.LAUNCHES == before


def test_blur_rejects_bad_inputs():
    fb = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(TypeError):
        blur.dof_blur(fb.to(torch.int64), torch.zeros((4, 8)))
    with pytest.raises(ValueError):
        blur.dof_blur(fb, torch.zeros((4, 9)))
