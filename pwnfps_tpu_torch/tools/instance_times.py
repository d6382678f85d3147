"""Every rendering instance of the tracer kernel, two of its measurement
instances (profile, with its per-wave step counts written, and fire1)
and every form of the blur kernel, held against their plain versions
and timed on the card.

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

The blur cases (BLUR_CASES) blur the frames that the tracer kernel
writes for a tracer case, as render_frame finds them: `dof_blur` on one
frame or on the 64 stacked multicam frames, and `dof_blur_band` on the 8
bands of the flagship's frame 3 (chip_smoke phase 11a).  Each is held
bit for bit against its plain version (`--no-check` records the
equality without raising, for copies built to measure, not to be
right) and timed three ways: back to back (`ms`), queued behind one long
`vpu_chains` launch so that no launch waits for the host (`queued_ms`,
the device's time including the gaps between kernels), and the blur
kernels' own durations in a torch.profiler trace (`kernel_us`, a band
case's per band).

It also reads the host's cost to issue a launch (`host_issue_us`) of
`add_one` (K5), the flagship `trace_wave`, `dof_blur` at 1080p and
`dof_blur_band` on a flagship band: the host-clock time of ISSUE_N calls
issued while one long `vpu_chains` launch, queued before them, keeps the
card busy, so that no call waits for the device.

Each run appends one JSON line to `--out`: the tag, the card's name and
power limit, the ptxas line of every trace_kernel instance, the
flagship launch's shape where the tree reports it, each case's ms,
each blur case's three readings, the blur library's ptxas lines and
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
from pwnfps_tpu_torch.parallel import sharding
from pwnfps_tpu_torch.parallel.sharding import camera_rays
from pwnfps_tpu_torch.render.frame import frame_rays, pixel_seeds

REPS = 20
BLUR_REPS = 100        # blur launches a reading (band cases: 8 each)
ISSUE_N = 100          # calls a host-issue reading times
ISSUE_ROUNDS = 3       # readings a function; the least is kept
ISSUE_T = 20000        # vpu_chains iterations (fma, S=16, a block an SM)


# name: (scene builder, width, height, keyword arguments, frame)
CASES = {
    "flagship_1080": (S.flagship_scene, 1920, 1080, {}, 0),
    "stress_720": (S.stress_scene, 1280, 720, {}, 0),
    "maze_720": (S.maze_scene, 1280, 720, {}, 0),
    "maze_720_portal": (S.maze_scene, 1280, 720, {"view": "portal"}, 0),
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
    # measurement instances on the flagship frame (chip_smoke phase 17)
    "profile_1080": (S.flagship_scene, 1920, 1080, {"profile": True}, 0),
    "fire1_1080": (S.flagship_scene, 1920, 1080, {"probe": "fire1"}, 0),
}
# blur case: (tracer case whose kernel frame it blurs, frame_h or None);
# band_1080 blurs the flagship's frame 3 in 8 bands
BLUR_CASES = {
    "blur_1080": ("flagship_1080", None),
    "blur_stress_720": ("stress_720", None),
    "blur_maze_720": ("maze_720", None),
    "blur_frames": ("multicam", 120),
    "band_1080": None,
}
N_BANDS = 8


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
    # the portal view through scene.portal_camera, which every version
    # of the port has (an older tree's maze_scene takes no `view`)
    kw = dict(kw)
    view = kw.pop("view", "path")
    sc = make(w, h, dev, **kw)
    if view == "portal":
        sc.cam = S.portal_camera(sc)
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


def flagship_bands(dev) -> tuple[list, int]:
    """([(fb_pad, zb, y0)] of the N_BANDS bands of the flagship's frame 3
    as the banded mesh path pads them, frame height)."""
    sc = S.flagship_scene(1920, 1080, dev)
    origin, rayb, rdx, rdy, sec = sc.frame_args(3)
    ifrom, rays, seeds = frame_rays(sc.cfg, origin, rayb, rdx, rdy, dev)
    fb, z = tracer.trace_wave(sc.tworld, sc.cfg, ifrom, rays, seeds, sec,
                              pack=True, page0=sc.cfg.cam_page)
    h, w = sc.cfg.height, sc.cfg.width
    fb, z = fb.reshape(1, h, w), z.reshape(1, h, w)
    hb = sharding._band_rows(sc.cfg, N_BANDS)
    _, halo = sharding._halo(hb, N_BANDS)
    hp2 = hb * N_BANDS
    fbp = torch.nn.functional.pad(fb, (0, 0, halo, hp2 - h + halo))
    zp = torch.nn.functional.pad(z, (0, 0, 0, hp2 - h), value=1.0)
    return [(fbp[:, y0:y0 + hb + 2 * halo].contiguous(),
             zp[:, y0:y0 + hb].contiguous(), y0)
            for y0 in range(0, hp2, hb)], h


def blur_inputs(name: str, cases: dict, dev):
    """(launch, plain) of a blur case: `launch` runs the blur kernel,
    `plain` its plain version, on the kernel-traced frame (cases: tracer
    case inputs already built, reused when present)."""
    if BLUR_CASES[name] is None:
        bands, h = flagship_bands(dev)
        return ((lambda: [blur.dof_blur_band(fp, zb, y0, h)
                          for fp, zb, y0 in bands]),
                (lambda: [blur.dof_blur_band_plain(fp, zb, y0, h)
                          for fp, zb, y0 in bands]))
    tcase, frame_h = BLUR_CASES[name]
    wt, cfg, ifrom, rays, seeds, sec, page0 = (
        cases[tcase] if tcase in cases else case_inputs(tcase, dev))
    fb, z = tracer.trace_wave(wt, cfg, ifrom, rays, seeds, sec, pack=True,
                              page0=page0)
    fb, z = fb.view(-1, cfg.width), z.view(-1, cfg.width)
    return ((lambda: blur.dof_blur(fb, z, 1, frame_h)),
            (lambda: blur.dof_blur_plain(fb, z, 1, frame_h)))


def _equal(a, b) -> bool:
    a = a if isinstance(a, list) else [a]
    b = b if isinstance(b, list) else [b]
    return all(torch.equal(x, y) for x, y in zip(a, b))


def queued_ms(fn, dev, n: int = BLUR_REPS) -> float:
    """ms a call of fn on the device alone: CUDA events around n calls
    enqueued behind one long vpu_chains launch, so that the device runs
    them back to back whatever the host's issue time (gaps between
    kernels included)."""
    a = vpu_probe.plane(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(dev)
    probes.vpu_chains(a, "fma", 16, ISSUE_T, sms)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def kernel_us(fn, n: int = 20, name: str = "blur") -> float | None:
    """Mean device duration in us of the kernels fn launches whose name
    holds `name` (the blur's by default), from a torch.profiler trace of
    n calls (None where the trace shows no device time)."""
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
    except RuntimeError as e:            # no CUPTI: no reading
        print(f"kernel_us: no profiler trace ({e})", file=sys.stderr)
        return None
    tot, cnt = 0.0, 0
    for e in prof.events():
        dt = getattr(e, "device_type", None)
        if name in e.name and dt is not None and "CUDA" in str(dt):
            tot += e.time_range.elapsed_us()
            cnt += 1
    return tot / cnt if cnt else None


def blur_readings(names, cases: dict, dev, check: bool, tag: str) -> dict:
    """{case: {ms, queued_ms, kernel_us, equal}}: ms and queued_ms a call
    (a band case's call launches all 8 bands), kernel_us a launch."""
    out = {}
    for name in names:
        launch, plain = blur_inputs(name, cases, dev)
        eq = _equal(launch(), plain())
        if check and not eq:
            raise AssertionError(f"{tag}: blur kernel != plain on {name}")
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        launch()
        start.record()
        for _ in range(BLUR_REPS):
            launch()
        end.record()
        end.synchronize()
        out[name] = {"ms": start.elapsed_time(end) / BLUR_REPS,
                     "queued_ms": queued_ms(launch, dev),
                     "kernel_us": kernel_us(launch), "equal": eq}
    return out


def issue_readings(dev) -> dict:
    """host_issue_us of add_one on K5's [16320, 128], of the flagship
    trace_wave at 1080p, of dof_blur on its frame and of dof_blur_band on
    the middle band of the flagship's 8."""
    x = torch.rand((16320, 128), device=dev)
    wt, cfg, ifrom, rays, seeds, sec, page0 = case_inputs("flagship_1080",
                                                          dev)

    def trace():
        return tracer.trace_wave(wt, cfg, ifrom, rays, seeds, sec,
                                 pack=True, page0=page0)
    fb, z = trace()
    fb, z = fb.view(cfg.height, cfg.width), z.view(cfg.height, cfg.width)
    bands, h = flagship_bands(dev)
    fp, zb, y0 = bands[N_BANDS // 2]
    return {"add_one": host_issue_us(lambda: probes.add_one(x), dev),
            "trace_wave": host_issue_us(trace, dev),
            "dof_blur": host_issue_us(lambda: blur.dof_blur(fb, z), dev),
            "dof_blur_band": host_issue_us(
                lambda: blur.dof_blur_band(fp, zb, y0, h), dev)}


def blur_ptxas(log: str) -> list[str]:
    """The blur library's ptxas lines: each kernel's name, then its
    stack, spill and register lines."""
    return [ln.replace("ptxas info    : ", "").strip()
            for ln in log.splitlines()
            if "Compiling entry" in ln or "Function properties" in ln
            or "stack frame" in ln or "registers" in ln]


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
    p.add_argument("--cases", nargs="+",
                   default=list(CASES) + list(BLUR_CASES),
                   choices=list(CASES) + list(BLUR_CASES),
                   help="the cases to time")
    p.add_argument("--no-check", action="store_true",
                   help="record whether each blur case equals plain "
                        "instead of raising")
    args = p.parse_args(argv)
    bcases = [c for c in args.cases if c in BLUR_CASES]
    if not torch.cuda.is_available():
        raise SystemExit("instance_times: needs a CUDA device")
    dev = torch.device("cuda", 0)
    cases = {c: case_inputs(c, dev) for c in args.cases if c in CASES}
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
            if cfg.profile:
                return tracer.trace_wave_profile(wt, cfg, ifrom, rays, seeds,
                                                 sec, page0=page0)[:2]
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
    blurs = blur_readings(bcases, cases, dev, not args.no_check, args.tag)
    issue = issue_readings(dev)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    shape = None
    if hasattr(tracer, "launch_shape"):
        shape = tracer.launch_shape(S.flagship_scene(8, 8, dev).cfg,
                                    1920 * 1080, 1920, 1, dev)
    rec = {"tag": args.tag, "card": card, "ms": ms, "blur": blurs,
           "issue_us": issue, "launch": shape,
           "ptxas": ptxas(_build.PTXAS_LOG.get("tracer", "")),
           "blur_ptxas": blur_ptxas(_build.PTXAS_LOG.get("blur", ""))}
    print(json.dumps({"tag": args.tag, "card": card,
                      "ms": {c: round(v, 4) for c, v in ms.items()},
                      "blur": {c: {k: (round(v, 5) if isinstance(v, float)
                                       else v) for k, v in r.items()}
                               for c, r in blurs.items()},
                      "issue_us": {c: round(v, 3) for c, v in
                                   issue.items()}}))
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
