"""Where the time of the flagship frame goes, on one CUDA device.

    python -m pwnfps_tpu_torch.profile_frame [--trace PATH]

Renders bench.py's frame (1920x1080, fast mode, three bounce waves, one
DoF pass) through `render_frame` and prints:

- per-frame device time from CUDA events over 64 frames, after 4
  warm-up frames: median, p90, p99, min and max;
- the same frames issued back to back with one sync at the end, as
  ms/frame;
- a torch.profiler run over 16 frames: each device kernel's time per
  frame, the device span and busy time, and the idle share
  1 - busy/span (the share of the span in which no kernel or copy ran
  on the device).

Every timing line carries the card's name and power limit.  Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from collections import defaultdict

import numpy as np
import torch

W, H = 1920, 1080
FRAMES, WARMUP, PROFILED = 64, 4, 16


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _busy_us(spans) -> float:
    """Length of the union of [start, end) intervals, in us."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trace", default=None,
                    help="write the profiler's Chrome trace here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_frame: no CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from .render.frame import render_frame
    from .scene import flagship_scene

    smi = _card()
    dev = torch.device("cuda", 0)
    sc = flagship_scene(W, H, dev)
    cams = [sc.frame_args(k) for k in range(FRAMES)]

    def frame(k):
        return render_frame(sc.tworld, sc.meta, sc.cfg, *cams[k])

    for k in range(WARMUP):
        frame(k)
    torch.cuda.synchronize()

    ms = []
    for k in range(FRAMES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        frame(k)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    q = np.percentile(ms, [50, 90, 99])
    rays = W * H * sc.cfg.n_waves
    print(f"{FRAMES} frames {W}x{H}, CUDA events "
          f"per frame: median {q[0]:.4f} p90 {q[1]:.4f} p99 {q[2]:.4f} "
          f"min {min(ms):.4f} max {max(ms):.4f} ms; "
          f"{rays / q[0] / 1e3:.1f} Mrays/s at the median ({smi})")

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for k in range(FRAMES):
        frame(k)
    end.record()
    end.synchronize()
    print(f"back to back, one sync: "
          f"{start.elapsed_time(end) / FRAMES:.4f} ms/frame ({smi})")

    n = PROFILED
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for k in range(n):
            frame(k)
        torch.cuda.synchronize()
    if args.trace:
        prof.export_chrome_trace(args.trace)
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev_events:
        raise SystemExit("profile_frame: the profiler saw no device time")
    spans = [(e.time_range.start, e.time_range.end) for e in dev_events]
    span = max(e for _, e in spans) - min(s for s, _ in spans)
    busy = _busy_us(spans)
    print(f"profiler, {n} frames: {len(dev_events)} device events, span "
          f"{span / n:.1f} us/frame, busy {busy / n:.1f} us/frame, idle "
          f"share {1.0 - busy / span:.4f} ({smi})")
    per = defaultdict(lambda: [0.0, 0])
    for e in dev_events:
        per[e.name][0] += e.time_range.end - e.time_range.start
        per[e.name][1] += 1
    for name, (us, cnt) in sorted(per.items(), key=lambda kv: -kv[1][0]):
        print(f"  {us / n:10.1f} us/frame {cnt / n:6.1f} /frame "
              f"{100.0 * us / busy:5.1f}%  {name[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
