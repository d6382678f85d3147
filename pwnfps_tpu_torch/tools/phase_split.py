"""Where a frame's kernel time goes: the phases instance's clock64()
counters (ops/tracer.trace_wave_phases) by region, in parity or fast
mode.

    python -m pwnfps_tpu_torch.tools.phase_split [--cases NAME ...]

Each case's frame is traced through its one-chain instance (parity, or
fast mode's one-page or paged one) and through the phases instance,
which is the same kernel with counters around its regions
(csrc/tracer_body.cuh VAR_PHASES); their bits must agree.  The
counters are warp-cycles: a region counts once a warp each time the warp
runs it, whichever lanes take it.  Printed, a JSON line a case: both
instances' ms ("kernel" and "phases": the counters' cost), the raw
cycles, and the shares of the warps' kernel cycles: the DDA steps
(parity mode's bucket scan and its slot hits' root and quotient, fast
mode's sphere refresh included), the rest of the march (segment starts,
the step loop and the step counter), shading, unwind, the rest of a
tile's trace (the ray's loads, records, the pack), the block's prologue
and what lies between (a warp's start and end around its tile).  Needs
the card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

# name: (scene builder name, width, height, keyword arguments, frame)
CASES = {
    "parity_1080": ("parity_scene", 1920, 1080, {}, 0),
    "parity_1080_f2": ("parity_scene", 1920, 1080, {}, 2),
    "maze_parity_720": ("maze_scene", 1280, 720, {"parity": True}, 0),
    "parity_240": ("parity_scene", 320, 240, {}, 0),
    "maze_720": ("maze_scene", 1280, 720, {}, 0),
    "maze_720_portal": ("maze_scene", 1280, 720, {"view": "portal"}, 0),
    "maze_160x90": ("maze_scene", 160, 90, {}, 0),
    "flagship_1080": ("flagship_scene", 1920, 1080, {}, 0),
}
REPS = 5


def split(c: dict) -> dict:
    """Shares of the warps' kernel cycles, from the cycles by region."""
    parts = {
        "steps": c["steps"], "march_less_steps": c["march"] - c["steps"],
        "shade": c["shade"], "unwind": c["unwind"],
        "rest_of_tile": c["tile"] - c["march"] - c["shade"] - c["unwind"],
        "prologue": c["prologue"],
        "between": c["kernel"] - c["prologue"] - c["tile"]}
    return {k: v / c["kernel"] for k, v in parts.items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cases", nargs="+", default=list(CASES),
                   choices=list(CASES))
    args = p.parse_args(argv)

    import torch

    from pwnfps_tpu_torch import scene as S
    from pwnfps_tpu_torch.ops import tracer
    from pwnfps_tpu_torch.render.frame import frame_rays

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    for name in args.cases:
        make, w, h, kw, k = CASES[name]
        sc = getattr(S, make)(w, h, dev, **kw)
        origin, rayb, rdx, rdy, sec = sc.frame_args(k)
        ifrom, rays, seeds = frame_rays(sc.cfg, origin, rayb, rdx, rdy, dev)
        call = (sc.tworld, sc.cfg, ifrom, rays, seeds, sec)
        page0 = sc.cfg.cam_page

        def one_chain():
            return tracer.trace_wave(*call, pack=True, page0=page0)

        def phases_instance():
            return tracer.trace_wave_phases(*call, page0=page0)

        fb, dist = one_chain()
        fb_p, dist_p, _ = phases_instance()
        if not (torch.equal(fb, fb_p) and torch.equal(
                dist.view(torch.int32), dist_p.view(torch.int32))):
            raise RuntimeError(f"{name}: the phases instance's bits differ")
        ms = {}
        for label, fn in (("kernel", one_chain),
                          ("phases", phases_instance)):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(REPS):
                out = fn()
            end.record()
            end.synchronize()
            ms[label] = start.elapsed_time(end) / REPS
        # the last run's counters
        cycles = dict(zip(tracer.PHASES, out[2].tolist()))
        print(json.dumps({"case": name, "card": card, "ms": ms,
                          "warp_cycles": cycles, "share": split(cycles)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
