"""The port's probe kernels (K5 `add_one`, K4 `vpu_chains`, in
pwnfps_tpu_torch/ops/probes.py) and its two tools, on the CPU.

The TPU kernels are closures inside the JAX tools' `main()`
(tools/launch_probe.py:36-37, tools/vpu_probe.py:48-68), built after
`main` imports jax and parses its arguments, so a test cannot call them
without editing those files.  The plain versions are held instead, bit
for bit, to a numpy restatement of the kernels' bodies:

  * launch_probe.py:36-37: o = x + f32(1), here chained 3 times;
  * vpu_probe.py:48-68: m = a*f32(0.9999) + f32(1e-7); chain s starts
    at a + s; each of T iterations applies U = 32 updates to every chain
    in order, `fma` acc*m + a and `sel` where(acc > a, acc*m, a); the
    output is the sum of the chains in order.  numpy's float32 multiply
    and add round once each, as the TPU and the kernel built with
    --fmad=false do.

Each tool's `main(["--device", "cpu", ...])` runs at its smallest size
and prints the JAX tool's JSON fields and the port's own.
"""

import json

import numpy as np
import pytest
import torch

from pwnfps_tpu_torch.ops import probes
from pwnfps_tpu_torch.tools import launch_probe, vpu_probe

F = np.float32


def _np_chains(a, variant, S, T):
    """vpu_probe.py:48-68 in numpy float32."""
    m = a * F(0.9999) + F(1e-7)
    accs = [a + F(s) for s in range(S)]
    with np.errstate(over="ignore", invalid="ignore"):
        for _ in range(T):
            for _u in range(32):
                for s in range(S):
                    if variant == "fma":
                        accs[s] = accs[s] * m + a
                    else:
                        accs[s] = np.where(accs[s] > a, accs[s] * m, a)
        acc = accs[0]
        for x in accs[1:]:
            acc = acc + x
    return acc


def test_add_one_chain_matches_numpy():
    x = np.random.default_rng(3).normal(size=(16, 128)).astype(np.float32)
    x[0, :4] = [np.inf, -np.inf, np.nan, -1.0]
    got = torch.from_numpy(x)
    want = x
    before = probes.LAUNCHES_ADD_ONE
    for _ in range(3):
        got = probes.add_one(got)
        want = want + F(1.0)
    assert np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    assert probes.LAUNCHES_ADD_ONE == before      # CPU: the plain version


@pytest.mark.parametrize("S", [1, 4])
@pytest.mark.parametrize("variant", ["fma", "sel"])
def test_vpu_chains_plain_matches_numpy(variant, S):
    a = vpu_probe.plane("cpu")
    before = probes.LAUNCHES_VPU
    got = probes.vpu_chains(a, variant, S, 3, blocks=2)
    want = _np_chains(a.numpy(), variant, S, 3)
    assert got.shape == (2, 8, 128)
    for b in range(2):
        assert np.array_equal(got[b].numpy().view(np.uint32),
                              want.view(np.uint32))
    assert probes.LAUNCHES_VPU == before          # CPU: the plain version
    assert probes.chain_ops(variant, S, 3, 2) == \
        2 * 1024 * 3 * 32 * S * probes.OPS_PER_UPDATE[variant]


def test_probe_wrappers_reject_bad_inputs():
    a = vpu_probe.plane("cpu")
    for args in (("fmax", 1, 1), ("fma", 2, 1), ("sel", 4, -1)):
        with pytest.raises(ValueError):
            probes.vpu_chains(a, *args)
    with pytest.raises(ValueError):
        probes.vpu_chains(a[:4], "fma", 1, 1)
    with pytest.raises(ValueError):
        probes.add_one(torch.zeros(4, dtype=torch.float64))


def test_launch_probe_main_prints_fields(capsys):
    assert launch_probe.main(["--device", "cpu", "--ns", "1", "2",
                              "--reps", "2", "--tiles", "1",
                              "--rows", "8"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    # the JAX tool's fields, then the graph's and the port's own
    assert set(out["ms_by_n"]) == {"1", "2"}
    assert np.isfinite(out["per_call_ms"])
    assert out["ms_by_n_graph"] is None and out["per_call_ms_graph"] is None
    assert out["device"] == "cpu"


def test_vpu_probe_main_prints_fields(capsys):
    assert vpu_probe.main(["--device", "cpu", "--T", "1"]) == 0
    recs = [json.loads(ln) for ln in
            capsys.readouterr().out.strip().splitlines()]
    assert [(r["variant"], r["S"]) for r in recs] == [
        (v, s) for v in ("fma", "sel") for s in (1, 4, 16)]
    for r in recs:
        # the JAX tool's fields (its 940 MHz cycle rate excepted: that
        # clock is the TPU's), then the port's own
        assert {"variant", "S", "T", "ms", "vreg_ops_per_us"} <= set(r)
        assert (r["T"], r["blocks"], r["device"]) == (1, 1, "cpu")
        assert r["ops_per_us"] == pytest.approx(1024 * r["vreg_ops_per_us"])
        assert "tops" not in r and "sm_clock_mhz" not in r
