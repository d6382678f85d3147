"""Hold the card's IEEE square root and division to the integer
emulations of core/ieee.py (csrc/ieee_check.cu).

The tracer's parity instances take `__fsqrt_rn` and `__fdiv_rn` for
the exact roots and quotients of the bucket scan and the ramp step,
which the plain parity tracer computes with core/ieee.py's integer
`sqrt_rn` and `div_rn`.  This runs both on the card over each operand
set of csrc/ieee_check.cu and counts the pairs whose bits differ:

    python -m pwnfps_tpu_torch.tools.ieee_check [--seed S]

prints one JSON line of {set: {pairs, mismatches, first}} and exits 1 on
any mismatch.  Needs the card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys

import torch

from .._launch import Entry

# set name: (csrc/ieee_check.cu's set, pairs)
SETS = {
    "sqrt_all_normals": (0, 0x7F800000 - 0x00800000),
    "div_random": (1, 1 << 28),
    "div_equal_mantissas": (2, 1 << 26),
    "div_exponent_extremes": (3, 121 << 20),
    "div_range_ends": (4, 1 << 26),
    "div_calcrad2_over_rad2": (5, 1 << 26),
    "div_one_over_ay2": (6, 127 << 23),
}
_CHECK = Entry("ieee_check", "pwnfps_ieee_check",
               [ctypes.c_int, ctypes.c_ulonglong, ctypes.c_ulonglong,
                ctypes.c_int, ctypes.c_void_p])


def check(name: str, device, seed: int = 12) -> dict:
    """Run operand set `name` on `device`: {pairs, mismatches, first},
    first the index of the first pair whose bits differ, or None."""
    code, count = SETS[name]
    dev = torch.device(device)
    out = torch.zeros(3, dtype=torch.int64, device=dev)
    out[1] = -1
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    _CHECK(dev.index or 0, code, seed, count, sms * 8, out.data_ptr())
    bad, first, pairs = out.tolist()
    return {"pairs": pairs, "mismatches": bad,
            "first": None if bad == 0 else first}


def check_all(device, seed: int = 12) -> dict:
    return {name: check(name, device, seed) for name in SETS}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=12)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ieee_check: needs a CUDA device")
    res = check_all(torch.device("cuda", 0), args.seed)
    print(json.dumps(res))
    return 1 if any(r["mismatches"] for r in res.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
