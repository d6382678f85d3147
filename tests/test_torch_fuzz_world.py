"""The port's fuzz world (scene.fuzz_rays), on which the card tests and
tools/host_trace.py hold the parity step's branches, is the JAX
package's fuzz level with its spheres; its rays are seeded, and the
phases instance, which has no plain version, refuses CPU tensors."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pwnfps_tpu_torch import scene as S
from pwnfps_tpu_torch.ops import tracer

from .test_space_skip import FUZZ_LEVEL, FUZZ_SPHERES


def test_fuzz_world_is_the_jax_tests_level():
    assert S.FUZZ_LEVEL == FUZZ_LEVEL
    assert S.FUZZ_SPHERES == FUZZ_SPHERES


def test_fuzz_rays_are_seeded_and_start_near_their_bases():
    wt, cfg, ifrom, rays, seeds = S.fuzz_rays(40, "cpu", seed=3)
    again = S.fuzz_rays(40, "cpu", seed=3)
    assert all(torch.equal(a, b) for a, b in zip((*ifrom, *rays, seeds),
                                                 (*again[2], *again[3],
                                                  again[4])))
    assert cfg.parity and cfg.maxsteps == 200 and wt.n_spheres == 6
    f = np.stack([c.numpy() for c in ifrom], 1)
    base = np.array(S.FUZZ_BASES)[np.arange(40) % len(S.FUZZ_BASES)]
    assert (np.abs(f - base) <= 0.45 + 1e-6).all()
    d = np.stack([c.numpy() for c in rays], 1)
    assert np.isfinite(d).all() and (np.linalg.norm(d, axis=1) <= 1.0
                                     + 1e-6).all()


def test_phases_instance_refuses_the_cpu():
    wt, cfg, ifrom, rays, seeds = S.fuzz_rays(32, "cpu")
    with pytest.raises(ValueError, match="card"):
        tracer.trace_wave_phases(wt, cfg, ifrom, rays, seeds,
                                 np.float32(0.25))
