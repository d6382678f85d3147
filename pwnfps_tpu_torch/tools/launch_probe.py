"""Cost of one kernel launch through the port's route (the counterpart
of tools/launch_probe.py, which reads the cost of one pallas_call inside
one jitted executable).

Chains n launches of the `add_one` kernel (ops/probes.py, o = x + 1 over
an f32 [tiles*rows, 128] array; by default 255 x 64 rows, the 1080p
trace call's grid on the TPU) for n in --ns, and times the chain two
ways, each the best of --reps runs on the host clock up to a
synchronize:

  * eagerly, a ctypes call and its error check a launch, as the port
    issues every kernel;
  * captured once in a CUDA graph (`torch.cuda.CUDAGraph`) and replayed,
    the counterpart of JAX's one executable.

The slope of each over n is the cost of one launch in that form
(`per_call_ms`, `per_call_ms_graph`).  With `--tiles 1` the kernel is
negligible and the slope is the launch alone.  On `--device cpu` the
chain is the plain version and there is no graph.

    python -m pwnfps_tpu_torch.tools.launch_probe [--tiles 1]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from ..ops.probes import add_one


def _best_ms(fn, reps: int, sync) -> float:
    fn()                                   # warm-up
    sync()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        best = min(best, time.perf_counter() - t0)
    return 1000.0 * best


def _slope(ms_by_n: dict) -> float:
    ns = sorted(ms_by_n)
    if len(ns) < 2:
        return float("nan")
    return (ms_by_n[ns[-1]] - ms_by_n[ns[0]]) / (ns[-1] - ns[0])


def _chain(x, n):
    for _ in range(n):
        x = add_one(x)
    return x


def capture_chain(x, n) -> torch.cuda.CUDAGraph:
    """The chain of n launches on x, captured once."""
    side = torch.cuda.Stream(x.device)
    side.wait_stream(torch.cuda.current_stream(x.device))
    with torch.cuda.stream(side):
        _chain(x, n)                       # warm up off the capture
    torch.cuda.current_stream(x.device).wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        _chain(x, n)
    return g


def run(ns=(1, 2, 4, 8), reps: int = 30, rows: int = 64, tiles: int = 255,
        device="cuda") -> dict:
    dev = torch.device(device)
    x = torch.ones((tiles * rows, 128), dtype=torch.float32, device=dev)
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    eager = {n: _best_ms(lambda: _chain(x, n), reps, sync) for n in ns}
    graph = None
    if cuda:
        graph = {}
        for n in ns:
            g = capture_chain(x, n)
            graph[n] = _best_ms(g.replay, reps, sync)
    return {"ms_by_n": eager, "per_call_ms": _slope(eager),
            "ms_by_n_graph": graph,
            "per_call_ms_graph": _slope(graph) if graph else None,
            "device": (torch.cuda.get_device_name(dev) if cuda else "cpu")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ns", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--rows", type=int, default=64)
    ap.add_argument("--tiles", type=int, default=255)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.ns, args.reps, args.rows, args.tiles,
                         args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
