"""Run one cell of the port's benchmark once, on one CUDA card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

(or `python3 -m portbench.run ...`) from the root of a checkout.  Prints
diagnostics and, as its last lines, each number the correctness check
compared beside its limit on standard error; prints one JSON object as
the last line of standard output: correct, attempted, failed, metrics
(the cell's end-to-end metrics, or with --trace 1 its per-layer ones),
device, with --trace 1 breakdown, and last the checks.

Exits 2, printing no result, without a CUDA card (or with fewer than the
cell asks for), and 3 when a module of JAX or of the JAX package was
loaded once the window had closed.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness

    _, cell, _, _ = harness.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), device="cuda", root=ROOT,
                              t_process=T_PROCESS)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
