"""The control of the correctness check: a lower precision in the
program's place, which the check has to find not correct.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3

Each configuration names its control ("control" in its file):

  * bf16_rays (fast mode, whose configuration states float32): the
    plain reference put in the program's place with its ray directions
    computed in bfloat16, the nearest precision below float32 (the
    glue's step that would tempt a later change), the rest in float32;
  * fast_math (parity mode, whose configuration states the C
    reference's bit-exact math): the program's own lower-precision path,
    fast mode, switched on for the same world, frames and settings.

A control run is a run of the cell with `issue` replaced: no warm-up, a
window of at least as many steps as a run compares, and the same
comparison.  The benchmark's own runs never run it.  Prints one line a
seed with the numbers compared beside their limits.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def bf16_rays():
    """issue(traffic, inputs): the reference's whole frame, rays in
    bfloat16."""
    import torch
    state = {}

    def issue(tr, inputs):
        dev = tr.world.ent.device
        if "rw" not in state:
            state["rw"] = tr.ref_world(dev)
        n = tr.width * tr.height
        (fb, z), = tr.reference(state["rw"],
                                [(inputs, torch.arange(n, device=dev))],
                                ray_dtype=torch.bfloat16)
        return fb.view(tr.height, tr.width), z.view(tr.height, tr.width)
    return issue


def fast_math():
    """issue(traffic, inputs): the program in fast mode."""
    def issue(tr, inputs):
        from pwnfps_tpu_torch.render.frame import render_frame
        cfg = dataclasses.replace(tr.cfg, parity=False, samples=tr.samples)
        return render_frame(tr.world, tr.meta, cfg, *inputs)
    return issue


CONTROLS = {"bf16_rays": bf16_rays, "fast_math": fast_math}


def run(workload: str, seed: int, device="cuda", root: str = ROOT,
        overrides: dict | None = None, log=print) -> dict:
    """One control run of `workload`: the run's result, its checks."""
    from . import harness
    _, _, config, params = harness.load_cell(root, workload)
    ov = {"warmup_steps": 0, **(overrides or {})}
    return harness.run_cell(workload, seed, 0.0, False, device=device,
                            root=root, overrides=ov,
                            issue=CONTROLS[config["control"]](),
                            min_steps=int(params["check_frames"]), log=log)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds, one control run each")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        r = run(args.workload, seed, args.device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": r["correct"],
                          "checks": r["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
