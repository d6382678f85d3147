"""Every rendering instance of the tracer kernel, held against the plain
tracer and timed on the card.

Traces one frame of each case (chip_smoke's scenes and shapes; frame 0
but where the case names another) through
`ops.tracer.trace_wave`, holds fb and zbuf bit for bit against
`trace_wave_plain`, and times REPS back-to-back launches with CUDA
events.  It calls only entry points that every version of the port
has, so the same file times the kernels of another checkout, or of a
copy whose `csrc/` was edited: run this file with that tree first on
the path,

    PYTHONPATH=path/to/tree python path/to/tools/instance_times.py \\
        --tag name --ref plain.pt --out times.jsonl

It also reads the host's cost to issue a launch (`host_issue_us`) of
`add_one` (K5), the flagship `trace_wave` and `dof_blur` at 1080p: the
host-clock time of ISSUE_N calls issued while one long `vpu_chains`
launch, queued before them, keeps the card busy, so that no call waits
for the device.

Each run appends one JSON line to `--out`: the tag, the card's name and
power limit, the ptxas line of every trace_kernel instance, the
flagship launch's shape where the tree reports it, each case's ms and
each host-issue reading in us a launch.
`--ref` keeps the plain outputs in a file (they do not depend on the
kernel), so that a series of runs computes them once.  Needs the card
and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import torch

from pwnfps_tpu_torch import _build, scene as S
from pwnfps_tpu_torch.ops import blur, probes, tracer
from pwnfps_tpu_torch.tools import vpu_probe
from pwnfps_tpu_torch.parallel.sharding import camera_rays
from pwnfps_tpu_torch.render.frame import frame_rays, pixel_seeds

REPS = 20
ISSUE_N = 100          # calls a host-issue reading times
ISSUE_ROUNDS = 3       # readings a function; the least is kept
ISSUE_T = 20000        # vpu_chains iterations (fma, S=16, a block an SM)
# name: (scene builder, width, height, keyword arguments, frame)
CASES = {
    "flagship_1080": (S.flagship_scene, 1920, 1080, {}, 0),
    "stress_720": (S.stress_scene, 1280, 720, {}, 0),
    "maze_720": (S.maze_scene, 1280, 720, {}, 0),
    "maze_samples_160x90": (S.maze_scene, 160, 90, {"samples": 2}, 0),
    "ptrace_1080": (S.ptrace_scene, 1920, 1080, {}, 0),
    "fused_1080": (S.flagship_scene, 1920, 1080, {"fused": True}, 0),
    "fused_stress_720": (S.stress_scene, 1280, 720, {"fused": True}, 0),
    "fused_320x180": (S.flagship_scene, 320, 180, {"fused": True}, 0),
    "parity_240": (S.parity_scene, 320, 240, {}, 0),
    "parity_1080": (S.parity_scene, 1920, 1080, {}, 0),
    # the frame chip_smoke phase 6 traces at 1080p
    "parity_1080_f2": (S.parity_scene, 1920, 1080, {}, 2),
    "parity_ptrace_1080": (S.ptrace_scene, 1920, 1080, {"parity": True}, 0),
    "maze_parity_720": (S.maze_scene, 1280, 720, {"parity": True}, 0),
    "multicam": None,
}


def case_inputs(name: str, dev) -> tuple:
    """(world, cfg, ifrom, rays, seeds, sec, page0) of the case's frame
    (multicam: step 1 of its 64 cameras)."""
    if name == "multicam":
        mc = S.multicam_scene(dev)
        cams, sec = mc.step_args(1)
        ifrom, rays, seeds = camera_rays(
            mc.cfg, torch.from_numpy(cams).to(dev),
            pixel_seeds(mc.cfg.width, mc.cfg.height, dev))
        return mc.tworld, mc.cfg, ifrom, rays, seeds, sec, mc.cfg.cam_page
    make, w, h, kw, k = CASES[name]
    sc = make(w, h, dev, **kw)
    origin, rayb, rdx, rdy, sec = sc.frame_args(k)
    ifrom, rays, seeds = frame_rays(sc.cfg, origin, rayb, rdx, rdy, dev)
    return sc.tworld, sc.cfg, ifrom, rays, seeds, sec, sc.cfg.cam_page


def host_issue_us(fn, dev, n: int = ISSUE_N) -> float:
    """Host-clock us to issue one call of fn: n calls issued while one
    long vpu_chains launch, queued before them, keeps the card busy (on
    the H100 it runs for tens of ms), so no call waits for the device;
    the least of ISSUE_ROUNDS readings."""
    a = vpu_probe.plane(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    fn()
    best = float("inf")
    for _ in range(ISSUE_ROUNDS):
        torch.cuda.synchronize(dev)
        probes.vpu_chains(a, "fma", 16, ISSUE_T, sms)
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        best = min(best, time.perf_counter() - t0)
        torch.cuda.synchronize(dev)
    return best / n * 1e6


def issue_readings(dev) -> dict:
    """host_issue_us of add_one on K5's [16320, 128], of the flagship
    trace_wave at 1080p and of dof_blur on its frame."""
    x = torch.rand((16320, 128), device=dev)
    wt, cfg, ifrom, rays, seeds, sec, page0 = case_inputs("flagship_1080",
                                                          dev)

    def trace():
        return tracer.trace_wave(wt, cfg, ifrom, rays, seeds, sec,
                                 pack=True, page0=page0)
    fb, z = trace()
    fb, z = fb.view(cfg.height, cfg.width), z.view(cfg.height, cfg.width)
    return {"add_one": host_issue_us(lambda: probes.add_one(x), dev),
            "trace_wave": host_issue_us(trace, dev),
            "dof_blur": host_issue_us(lambda: blur.dof_blur(fb, z), dev)}


def ptxas(log: str) -> dict:
    """{template arguments of each trace_kernel instance: its stack,
    spill and register lines} from the `-Xptxas -v` report."""
    out, key = {}, None
    for ln in log.splitlines():
        if "Function properties for" in ln:
            m = re.search(r"trace_kernel(I(?:Lb[01]E|Li\d+E)+E)", ln)
            key = m.group(1) if m else None
        elif key and ("stack frame" in ln or "registers" in ln):
            line = ln.replace("ptxas info    : ", "").strip()
            out[key] = f"{out[key]}; {line}" if key in out else line
            if "registers" in ln:
                key = None
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tag", default="tree")
    p.add_argument("--ref", default=None,
                   help="file of the plain outputs, written if absent")
    p.add_argument("--out", default=None, help="JSON lines to append to")
    p.add_argument("--cases", nargs="+", default=list(CASES),
                   choices=list(CASES), help="the cases to time")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("instance_times: needs a CUDA device")
    dev = torch.device("cuda", 0)
    cases = {c: case_inputs(c, dev) for c in args.cases}
    ref = (torch.load(args.ref) if args.ref and os.path.exists(args.ref)
           else {})
    if any(c not in ref for c in cases):
        for c in cases:
            wt, cfg, ifrom, rays, seeds, sec, page0 = cases[c]
            fb, z = tracer.trace_wave_plain(wt, cfg, ifrom, rays, seeds, sec,
                                            True, page0=page0)
            ref[c] = (fb.cpu(), z.cpu())
        if args.ref:
            torch.save(ref, args.ref)
    ms = {}
    for c in cases:
        wt, cfg, ifrom, rays, seeds, sec, page0 = cases[c]

        def launch():
            return tracer.trace_wave(wt, cfg, ifrom, rays, seeds, sec,
                                     pack=True, page0=page0)
        fb, z = launch()
        if not (torch.equal(fb.cpu(), ref[c][0]) and torch.equal(
                z.cpu().view(torch.int32), ref[c][1].view(torch.int32))):
            raise AssertionError(f"{args.tag}: kernel != plain tracer on {c}")
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            launch()
        end.record()
        end.synchronize()
        ms[c] = start.elapsed_time(end) / REPS
    issue = issue_readings(dev)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    shape = None
    if hasattr(tracer, "launch_shape"):
        shape = tracer.launch_shape(S.flagship_scene(8, 8, dev).cfg,
                                    1920 * 1080, 1920, 1, dev)
    rec = {"tag": args.tag, "card": card, "ms": ms, "issue_us": issue,
           "launch": shape,
           "ptxas": ptxas(_build.PTXAS_LOG.get("tracer", ""))}
    print(json.dumps({"tag": args.tag, "card": card,
                      "ms": {c: round(v, 4) for c, v in ms.items()},
                      "issue_us": {c: round(v, 3) for c, v in
                                   issue.items()}}))
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
