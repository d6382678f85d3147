"""The port's parity-mode primitives (pwnfps_tpu_torch/core/ieee.py,
detmath.py, approx.py) against the JAX package's numpy path (xp=np), bit
for bit, on 500k inputs each drawn with a numpy seed over the engine's
domain, plus edge values.

Domains: div_rn gets positive f32 pairs (squared distances over squared
radii, 1 over |ray components| down to 1e-13) and random positive bit
patterns, whose quotients leave the normal range and take the IEEE
division on both sides; sqrt_rn, rsqrt_emu and rcp_emu get positive f32
over the whole exponent range; sin/cos get |x| < 4096 (the water normal's
arguments); exp gets [-150, 88] (the fog factor exp(-0.6 fog))."""

import numpy as np
import pytest
import torch

from pwnfps_tpu.core import approx as ref_approx
from pwnfps_tpu.core import detmath as ref_detmath
from pwnfps_tpu.core import ieee as ref_ieee
from pwnfps_tpu_torch.core import approx, detmath, ieee
from pwnfps_tpu_torch.core.approx import SseTables

N = 500_000
F32_EDGES = np.array([0.0, 1.0, 2.0, 0.5, 1e-13, 1.1754944e-38,
                      3.4028235e38, 1.4e-45, 1e-40, np.inf, np.nan,
                      1.0000001, 0.99999994, 3.0, 7.0], np.float32)


def _pos_bits(rng, n):
    """Positive f32 from random bit patterns: every exponent (subnormals
    and zero included), no inf or NaN."""
    b = rng.integers(0, 0x7F800000, n, dtype=np.int64).astype(np.uint32)
    return b.view(np.float32)


def _log_uniform(rng, lo, hi, n):
    return np.exp(rng.uniform(np.log(lo), np.log(hi), n)).astype(
        np.float32)


def _inputs(name):
    rng = np.random.default_rng(20261016 + len(name))
    h = N // 2
    if name == "div_rn":
        a = np.concatenate([_log_uniform(rng, 1e-8, 1e4, h),
                            _pos_bits(rng, N - h), F32_EDGES,
                            np.ones_like(F32_EDGES)])
        b = np.concatenate([_log_uniform(rng, 1e-13, 1e4, h),
                            _pos_bits(rng, N - h),
                            np.ones_like(F32_EDGES), F32_EDGES])
        return a, b
    if name in ("sqrt_rn", "rsqrt_emu", "rcp_emu"):
        return (np.concatenate([_log_uniform(rng, 1e-13, 1e6, h),
                                _pos_bits(rng, N - h), F32_EDGES]),)
    if name in ("sin_det", "cos_det"):
        x = rng.uniform(-4096.0, 4096.0, N).astype(np.float32)
        x[:h // 4] = rng.uniform(-8.0, 8.0, h // 4).astype(np.float32)
        k = np.arange(-200, 200, dtype=np.float32)
        pio2 = (k * np.float32(np.pi / 2)).astype(np.float32)
        small = F32_EDGES[np.abs(F32_EDGES) < 8.0]
        return (np.concatenate([x, pio2, small, -small]),)
    assert name == "exp_det"
    x = rng.uniform(-150.0, 88.0, N).astype(np.float32)
    x[:h // 4] = rng.uniform(-2.0, 0.0, h // 4).astype(np.float32)
    return (np.concatenate([x, np.float32([0.0, -0.0, -87.3, -88.7,
                                           -103.9, 88.7, -1e-8])]),)


@pytest.fixture(scope="module")
def tables():
    return SseTables.load()


def _ref(name, args, tables):
    with np.errstate(all="ignore"):
        if name in ("div_rn", "sqrt_rn"):
            return getattr(ref_ieee, name)(*args)
        if name == "rsqrt_emu":
            return ref_approx.rsqrt_emu(args[0], tables.rsqrt)
        if name == "rcp_emu":
            return ref_approx.rcp_emu(args[0], tables.rcp)
        return getattr(ref_detmath, name)(*args)


def _port(name, args, tables):
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    if name in ("div_rn", "sqrt_rn"):
        return getattr(ieee, name)(*t)
    if name == "rsqrt_emu":
        return approx.rsqrt_emu(t[0], torch.from_numpy(
            tables.rsqrt.view(np.int32)))
    if name == "rcp_emu":
        return approx.rcp_emu(t[0], torch.from_numpy(
            tables.rcp.view(np.int32)))
    return getattr(detmath, name)(*t)


@pytest.mark.parametrize("name", ["div_rn", "sqrt_rn", "sin_det",
                                  "cos_det", "exp_det", "rsqrt_emu",
                                  "rcp_emu"])
def test_primitive_matches_numpy_path(name, tables):
    args = _inputs(name)
    assert args[0].size >= N
    want = np.asarray(_ref(name, args, tables), np.float32)
    got = _port(name, args, tables).numpy()
    same = got.view(np.uint32) == want.view(np.uint32)
    same |= np.isnan(got) & np.isnan(want)
    bad = np.flatnonzero(~same)
    assert bad.size == 0, (
        f"{bad.size} of {same.size} differ; first: "
        + ", ".join(f"{tuple(a[i] for a in args)} -> {got[i]!r} vs "
                    f"{want[i]!r}" for i in bad[:3]))


def test_div_sqrt_out_of_domain_take_the_ieee_ops():
    """Negative, zero and subnormal lanes take torch's IEEE / and sqrt,
    as the JAX package's jnp path takes XLA's (its numpy path reads the
    sign bit as part of a uint32 and is not the reference there)."""
    a = torch.tensor([-3.0, 3.0, -0.0, 0.0, -1e-40, 5.0],
                     dtype=torch.float32)
    b = torch.tensor([7.0, -7.0, 2.0, 0.0, 3.0, 1e-40],
                     dtype=torch.float32)
    x = torch.tensor([-4.0, -0.0, 0.0, -1e-40, 1e-40], dtype=torch.float32)
    for got, want in ((ieee.div_rn(a, b), a / b),
                      (ieee.sqrt_rn(x), torch.sqrt(x))):
        nan = torch.isnan(want)
        assert torch.equal(torch.isnan(got), nan)
        assert torch.equal(got[~nan].view(torch.int32),
                           want[~nan].view(torch.int32))


def test_tables_match_the_jax_loader(tables):
    from pwnfps_tpu.core.approx import SseTables as RefTables
    ref = RefTables.load()
    assert np.array_equal(tables.rsqrt, ref.rsqrt)
    assert np.array_equal(tables.rcp, ref.rcp)
