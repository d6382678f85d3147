"""The port's LCG (pwnfps_tpu_torch/core/lcg.py) against the JAX
package's numpy/uint32 LCG (pwnfps_tpu/core/lcg.py), bit for bit on
500k random uint32 states."""

import numpy as np
import pytest
import torch

from pwnfps_tpu.core import lcg as ref
from pwnfps_tpu_torch.core import lcg

N = 500_000


@pytest.fixture(scope="module")
def states():
    rng = np.random.default_rng(20261016)
    s = rng.integers(0, 2 ** 32, N, dtype=np.uint64).astype(np.uint32)
    return s, torch.from_numpy(s.astype(np.int64))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.uint32)


def test_randi_randfs(states):
    s_np, s_t = states
    ns, v = lcg.randi(s_t)
    ns_ref, v_ref = ref.randi(s_np)
    assert np.array_equal(_u32(ns), ns_ref)
    assert np.array_equal(_u32(v), v_ref)
    ns, f = lcg.randfs(s_t)
    ns_ref, f_ref = ref.randfs(s_np)
    assert np.array_equal(_u32(ns), ns_ref)
    assert np.array_equal(f.numpy().view(np.uint32), f_ref.view(np.uint32))


def test_jump(states):
    s_np, s_t = states
    s31 = s_np & ref.MASK31
    ak, ck = ref.jump_coeffs(300)
    k = np.random.default_rng(5).integers(0, 301, N)
    got = lcg.jump(torch.from_numpy(s31.astype(np.int64)),
                   torch.from_numpy(ak[k].astype(np.int64)),
                   torch.from_numpy(ck[k].astype(np.int64)))
    assert np.array_equal(_u32(got), ref.jump(s31, ak[k], ck[k]))


def test_pixel_and_row_seeds(states):
    s_np, _ = states
    # x, y spread over the full uint32 range exercise every wraparound
    x, y = s_np[: N // 2], s_np[N // 2:]
    for width in (64, 1920, 2 ** 31 + 5):
        got = lcg.pixel_seed(torch.from_numpy(x.astype(np.int64)),
                             torch.from_numpy(y.astype(np.int64)), width)
        assert np.array_equal(_u32(got), ref.pixel_seed(x, y, width))
    got = lcg.blur_row_seed(torch.from_numpy(y.astype(np.int64)))
    assert np.array_equal(_u32(got), ref.blur_row_seed(y))


def test_i32_bits_roundtrip(states):
    s_np, s_t = states
    bits = lcg.to_i32_bits(s_t)
    assert bits.dtype == torch.int32
    assert np.array_equal(bits.numpy().view(np.uint32), s_np)
    assert np.array_equal(_u32(lcg.u32(bits)), s_np)
