"""Per-wave step occupancy of the tracer (the counterpart of
tools/occupancy.py, which reads the Mosaic kernel's lane occupancy from
the jnp backend's `tstep`).

Traces a scene's frame with the profile instance
(`ops.tracer.trace_wave_profile`: each ray's terminal DDA step count in
each bounce wave) and groups the lanes four ways:

  * `tile`: the TPU kernel's (64, 128)-pixel tiles of 8192 lanes, with
    each tile's maximum rounded up to `step_chunk` (the while loop tests
    at chunk boundaries), so that the numbers compare with the JAX tool's;
  * `warp_tile`: the CUDA kernel's warps, each an 8x4-pixel tile
    (`ops.tracer.warp_tiles`), which run in lockstep: a warp steps as
    long as its longest ray, one cell a step, with no chunk rounding;
  * `warp`: 32 consecutive pixels of a row (32x1 strips), the warps of
    the kernel's flat order, for comparison;
  * `block`: `BLOCK` consecutive pixels, the blocks of that flat order.

For each grouping and wave: the share of live lanes, the p50/p99/max of
their step counts, `occupancy` = steps the lanes needed / steps their
groups executed (sum over live groups of max steps x lanes), and the
live groups; and over the chain, `fused_step_bound` (what a fused wave
loop could save: executed per wave over executed when a group runs its
longest lane's total), `needed_frac_unfused` and `needed_frac_fused`.
The CUDA kernel marches each ray's whole chain in one thread, so its
warps are closest to the fused model.

On the `ptrace` scene the tool also reads config #5's four samples
(`samples`): the primary wave draws no random number and chain k uses
the seeds seed + k*0x9E3779B9, so the profile instance run on those
seeds (`sample_seeds`) gives sample k's per-wave step counts exactly.
`samples_stats` counts, over the kernel's 8x4 warps, the step slots a
warp executes when each lane runs sample k's chain before sample k + 1
(the primary wave once, then for each sample and bounce wave the
longest lane) against the slots when each lane starts its next chain as
soon as its own ends (the longest lane's total): their ratio is the
most that refilling lanes can save in steps.

Scenes (`scene.py`): `default` the flagship frame at 1920x1080, `stress`
the portal chain at 1280x720, `maze` the paged maze at 1280x720 from its
camera page, `ptrace` the flagship's demo level at 1920x1080 with
reflect 6 and one chain (config #5's depth), each at sec 0.25 as the JAX
tool runs them.

    python -m pwnfps_tpu_torch.tools.occupancy [default stress maze ptrace]
        [--device cuda|cpu] [--width W --height H] [--out PATH]

Writes the JSON to --out (default pwnfps_tpu_torch/_build/occupancy.json)
and prints one line a scene.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from ..ops import tracer
from ..ops.tracer_core import WEYL
from ..render.frame import frame_rays
from ..scene import flagship_scene, maze_scene, ptrace_scene, stress_scene

SEC = 0.25
TILE_LANES = 8192            # the TPU kernel's tile, 64 x 128 pixels
BH, BW = 64, 128
WARP = 32
BLOCK = 128                  # a block of the flat order
SAMPLES = 4                  # config #5's chains a pixel (configs.py:286)
# beside the built kernels, in the package's git-ignored _build/
OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "_build", "occupancy.json")


def tile_ids(h: int, w: int) -> np.ndarray:
    """TPU tile id per pixel, [h*w] (tools/occupancy.py:_tile_ids)."""
    hp = -(-h // BH) * BH
    wp = -(-w // BW) * BW
    ids = np.arange((hp // BH) * (wp // BW)).reshape(hp // BH, wp // BW)
    per_px = np.repeat(np.repeat(ids, BH, 0), BW, 1)[:h, :w]
    return per_px.reshape(-1)


def lockstep_ids(n: int, size: int) -> tuple[np.ndarray, np.ndarray]:
    """(group id of each of n lanes in flat order, lanes a group) for
    groups of `size` consecutive threads; the last group may be short."""
    ids = np.arange(n) // size
    return ids, np.bincount(ids)


def warp_tile_ids(h: int, w: int) -> tuple[np.ndarray, np.ndarray]:
    """(the kernel's warp of each of the h*w pixels, live lanes a warp)
    for its 8x4-pixel tiles."""
    tiles = tracer.warp_tiles(h * w, w)
    ids = np.empty(h * w, np.int64)
    live = tiles >= 0
    ids[tiles[live]] = np.nonzero(live)[0]
    return ids, live.sum(axis=1)


def wave_stats(tstep: np.ndarray, ids: np.ndarray, lanes, chunk: int = 1):
    """Occupancy of each wave of tstep int [n_waves, n] (0: lane not live
    in that wave) over the groups `ids` [n], each executing `lanes` (a
    scalar or one a group) lanes for its longest lane's steps rounded up
    to `chunk`.  Returns (waves, summary) as tools/occupancy.py's
    wave_stats does, unrounded, plus needed_frac_fused."""
    n_groups = int(ids.max()) + 1
    lanes = np.broadcast_to(np.asarray(lanes, np.int64), (n_groups,))
    lane_total = np.zeros(tstep.shape[1], np.int64)
    exec_unfused = 0.0
    waves = []
    for k, steps in enumerate(np.asarray(tstep, np.int64)):
        act = steps > 0
        live = np.bincount(ids[act], minlength=n_groups) > 0
        tmax = np.zeros(n_groups, np.int64)
        np.maximum.at(tmax, ids[act], steps[act])
        tmax = -(-tmax // chunk) * chunk
        executed = float((tmax * lanes)[live].sum())
        needed = float(steps[act].sum())
        lane_total[act] += steps[act]
        exec_unfused += executed
        waves.append(dict(
            wave=k, live_frac=float(act.mean()),
            steps_p50=float(np.percentile(steps[act], 50))
            if act.any() else 0.0,
            steps_p99=float(np.percentile(steps[act], 99))
            if act.any() else 0.0,
            steps_max=int(steps[act].max()) if act.any() else 0,
            occupancy=needed / executed if executed else 1.0,
            live_groups=int(live.sum())))
    tmax_tot = np.zeros(n_groups, np.int64)
    np.maximum.at(tmax_tot, ids, lane_total)
    tmax_tot = -(-tmax_tot // chunk) * chunk
    exec_fused = float((tmax_tot * lanes)[tmax_tot > 0].sum())
    needed = float(lane_total.sum())
    summary = dict(
        fused_step_bound=exec_unfused / exec_fused if exec_fused else 1.0,
        needed_frac_unfused=needed / exec_unfused if exec_unfused else 1.0,
        needed_frac_fused=needed / exec_fused if exec_fused else 1.0)
    return waves, summary


def all_stats(tstep: np.ndarray, h: int, w: int, chunk: int) -> dict:
    """wave_stats over the TPU tiles, the kernel's warps (8x4 tiles),
    the 32x1 strips and the blocks of the flat order."""
    out = {}
    for name, (ids, lanes, ch) in (
            ("tile", (tile_ids(h, w), TILE_LANES, chunk)),
            ("warp_tile", (*warp_tile_ids(h, w), 1)),
            ("warp", (*lockstep_ids(h * w, WARP), 1)),
            ("block", (*lockstep_ids(h * w, BLOCK), 1))):
        waves, summary = wave_stats(tstep, ids, lanes, ch)
        out[name] = dict(waves=waves, **summary)
    return out


def samples_stats(tsteps, h: int, w: int) -> dict:
    """Step slots of the kernel's 8x4 warps over several samples of one
    frame.  tsteps: [samples, n_waves, h*w] terminal step counts, one
    profile trace a sample (wave 0, the primary, equal in all).  Returns
    `steps_today` (each warp: its longest lane's primary wave, then for
    every sample and bounce wave its longest lane, times its lanes),
    `steps_refill` (each warp: its longest lane's total, times its
    lanes), `needed` (the lanes' steps), `refill_gain` = today / refill
    and the two occupancies needed / executed; and the same counts of
    segments (a wave a lane reached: its step count is not 0), each of
    which is shaded once: `segments_today` (each warp: for every sample
    and wave any of its lanes reached, one shading pass of all its
    lanes), `segments_refill` (its lane with the most segments) and
    `segments_needed`."""
    t = np.asarray(tsteps, np.int64)
    if not (t[:, 0] == t[0, 0]).all():
        raise ValueError("the samples' primary waves differ")
    tiles = tracer.warp_tiles(h * w, w)
    lanes = (tiles >= 0).sum(axis=1)

    def per_warp(v):
        """[n_tiles, 32] of v [h*w], 0 on masked lanes."""
        return np.append(v, 0)[tiles]

    today = per_warp(t[0, 0]).max(axis=1)
    for k in range(t.shape[0]):
        for j in range(1, t.shape[1]):
            today = today + per_warp(t[k, j]).max(axis=1)
    total = t[0, 0] + t[:, 1:].sum(axis=(0, 1))
    refill = per_warp(total).max(axis=1)
    live = t > 0
    segs = live[0, 0] + live[:, 1:].sum(axis=(0, 1))
    seg_today = per_warp(live[0, 0]).max(axis=1).astype(np.int64)
    for k in range(t.shape[0]):
        for j in range(1, t.shape[1]):
            seg_today = seg_today + per_warp(live[k, j]).max(axis=1)
    steps_today = int((today * lanes).sum())
    steps_refill = int((refill * lanes).sum())
    needed = int(total.sum())
    return dict(samples=int(t.shape[0]), steps_today=steps_today,
                steps_refill=steps_refill, needed=needed,
                refill_gain=steps_today / steps_refill,
                occupancy_today=needed / steps_today,
                occupancy_refill=needed / steps_refill,
                segments_today=int((seg_today * lanes).sum()),
                segments_refill=int((per_warp(segs).max(axis=1)
                                     * lanes).sum()),
                segments_needed=int(segs.sum()))


def sample_seeds(seeds: torch.Tensor, k: int) -> torch.Tensor:
    """Sample k's chain seeds: seed + k*WEYL in uint32, as int32 bits."""
    s = (seeds.to(torch.int64) + k * WEYL) & 0xFFFFFFFF
    return torch.where(s >= 2 ** 31, s - 2 ** 32, s).to(torch.int32)


def scene(name: str, width: int, height: int, device):
    """The tool's scene `name` at width x height."""
    if name == "default":
        return flagship_scene(width, height, device)
    if name == "stress":
        return stress_scene(width, height, device)
    if name == "maze":
        return maze_scene(width, height, device)
    if name == "ptrace":
        return ptrace_scene(width, height, device, samples=1)
    raise ValueError(f"unknown scene {name!r}")


SCENES = {"default": (1920, 1080), "stress": (1280, 720),
          "maze": (1280, 720), "ptrace": (1920, 1080)}


def profile(sc, device, k: int = 0):
    """The scene's frame through the profile instance, on sample k's
    seeds: (fb, dist, tstep [n_waves, n])."""
    ifrom, rays, seeds = frame_rays(sc.cfg, *sc.frame_args(0)[:4], device)
    return tracer.trace_wave_profile(sc.tworld, sc.cfg, ifrom, rays,
                                     sample_seeds(seeds, k), SEC,
                                     page0=sc.cfg.cam_page)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("scenes", nargs="*", default=list(SCENES))
    p.add_argument("--device", default="cuda")
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--out", default=OUT)
    args = p.parse_args(argv)
    res = {}
    for name in args.scenes:
        w, h = SCENES[name]
        w, h = args.width or w, args.height or h
        sc = scene(name, w, h, args.device)
        _, _, tstep = profile(sc, args.device)
        dev = torch.device(args.device)
        res[name] = dict(res=f"{w}x{h}", reflect=sc.cfg.reflect,
                         device=(torch.cuda.get_device_name(dev)
                                 if dev.type == "cuda" else dev.type),
                         **all_stats(tstep.cpu().numpy(), h, w,
                                     max(1, sc.cfg.step_chunk)))
        if name == "ptrace":
            ts = [tstep.cpu().numpy()] + [
                profile(sc, args.device, k)[2].cpu().numpy()
                for k in range(1, SAMPLES)]
            res[name]["samples"] = samples_stats(ts, h, w)
        print(json.dumps({name: res[name]}), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
