"""FP32 and select issue rates of the card (the counterpart of
tools/vpu_probe.py, which read the TPU's vector-unit issue rate).

Runs the chains probe (ops/probes.vpu_chains: S independent chains over
one f32 (8, 128) plane, T iterations of 32 updates each; `fma` updates
acc*m + a, two operations, `sel` where(acc > a, acc*m, a), three) at the
JAX tool's six points, variant in (fma, sel) and S in (1, 4, 16) with
T = TOTAL[S] // (32*S), once with one block and once with as many blocks
as the card has SMs.  One block is one plane on one SM, as the TPU
kernel ran on one core; one block an SM, each on its own copy of the
plane, is the whole card.  The kernel is built with --fmad=false, so `fma` is an FMUL and an
FADD: the instruction mix the tracer runs.

Each point prints one JSON line: the time (CUDA events, the best of
three calls after a warm-up), `vreg_ops_per_us` ((8, 128)-plane
operations a microsecond, the JAX tool's unit), element `ops_per_us`,
`ops_per_cycle_per_sm` (one block an SM) at the SM clock `nvidia-smi --query-gpu=clocks.sm` reads right
after the timed calls (`sm_clock_mhz`), and the whole
card's rate `tops` beside the 67 T FP32 operations a second that the
bounds in PERF.md assume.  On `--device cpu` the probe is the plain
version, timed on the host clock, with no clock or rate of a card.

    python -m pwnfps_tpu_torch.tools.vpu_probe
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from ..ops.probes import (LANES, OPS_PER_UPDATE, ROWS, S_VALUES, U,
                          chain_ops, vpu_chains)

# total updates a point (vpu_probe.py:38)
TOTAL = {1: 4_000_000, 4: 8_000_000, 16: 16_000_000}
# the FP32 rate PERF.md's bounds assume (the H100 SXM data sheet)
ASSUMED_TOPS = 67.0
REPS = 3                # timed calls a point, the best kept (vpu_probe.py:85)


def sm_clock_mhz(index: int, query: str = "clocks.sm") -> float:
    """The SM clock nvidia-smi reads now on card `index` (or another of
    its clock fields, such as clocks.max.sm), in MHz."""
    out = subprocess.run(
        ["nvidia-smi", "-i", str(index), f"--query-gpu={query}",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0])


def _time_ms(fn, cuda: bool) -> float:
    fn()                                   # warm-up
    best = float("inf")
    for _ in range(REPS):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            best = min(best, 1000.0 * (time.perf_counter() - t0))
    return best


def plane(device) -> torch.Tensor:
    """The probe's input plane, in [1, 2) (vpu_probe.py:73), from a fixed
    seed."""
    a = np.random.default_rng(0).random((ROWS, LANES), dtype=np.float32)
    return torch.from_numpy(a + np.float32(1.0)).to(device)


def run(device="cuda", T=None):
    """One dict a (variant, S, blocks) point, blocks 1 and the SM count
    on a card, 1 on the CPU; T None = TOTAL[S] // (32*S)."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    blocks = [1] + ([torch.cuda.get_device_properties(dev)
                     .multi_processor_count] if cuda else [])
    a = plane(dev)
    out = []
    for nb in blocks:
        for variant in OPS_PER_UPDATE:
            for S in S_VALUES:
                t = TOTAL[S] // (U * S) if T is None else T
                ms = _time_ms(lambda: vpu_chains(a, variant, S, t, nb), cuda)
                ops = chain_ops(variant, S, t, nb)
                rec = {"variant": variant, "S": S, "T": t, "blocks": nb,
                       "ms": ms,
                       "vreg_ops_per_us": ops / (ROWS * LANES) / (ms * 1e3),
                       "ops_per_us": ops / (ms * 1e3)}
                if cuda:
                    mhz = sm_clock_mhz(dev.index or 0)
                    rec |= {"sm_clock_mhz": mhz,
                            "ops_per_cycle_per_sm":
                                rec["ops_per_us"] / mhz / nb,
                            "tops": rec["ops_per_us"] / 1e6,
                            "assumed_tops": ASSUMED_TOPS,
                            "device": torch.cuda.get_device_name(dev)}
                else:
                    rec["device"] = "cpu"
                out.append(rec)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--T", type=int, default=None,
                    help="iterations a point (default TOTAL[S] // (32*S))")
    args = ap.parse_args(argv)
    for rec in run(args.device, args.T):
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
