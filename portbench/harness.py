"""One run of one cell: set-up, the measured window, the check, the result.

Everything that belongs to one configuration, traffic mix or metric is
found by name: BENCHMARK.json's workload entry names the cell's
configuration (`configs/<config>.json`) and traffic mix
(`traffic/<traffic>.json`, whose "kind" names the generator module
`traffic/<kind>.py`); each metric of BENCHMARK.json is read by
`metrics/<name>.py`.

The window is a closed loop with `in_flight` steps in flight, as a
double-buffered swap chain keeps them: issue step j (one program call),
copy its framebuffer to one of `in_flight` pinned host buffers without
blocking, record an event, and before issuing step j + in_flight wait
for step j's event.  A step has landed when the host sees its event
done: polled after every issue, waited for before its buffer is reused.

With trace on, the profiler records `profile_steps` steps from the
middle of the window, issued into an empty pipeline and drained at the
end, so that the device events it records are those steps' alone.
"""

from __future__ import annotations

import collections
import dataclasses
import importlib
import importlib.util
import json
import os
import sys
import time

import numpy as np

# loaded modules whose top-level name may not be one of these once the
# window has closed: the JAX stack and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "pwnfps_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, whole, is in FORBIDDEN."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(root: str, workload: str):
    """(BENCHMARK.json, its workload entry, configuration, traffic mix)."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    here = os.path.dirname(os.path.abspath(__file__))
    config = load_json(os.path.join(here, "configs",
                                    f"{cell['config']}.json"))
    traffic = load_json(os.path.join(here, "traffic",
                                     f"{cell['traffic']}.json"))
    return bench, cell, config, traffic


def metric_reader(name: str):
    """metrics/<name>.py, loaded by file (a name may hold dots)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics._{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The metrics this cell reports in a run with or without trace."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in bench[key]
            if "workloads" not in m or workload in m["workloads"]]


@dataclasses.dataclass
class Step:
    j: int
    t_issue: float
    t_ret: float = 0.0
    t_land: float = 0.0
    profiled: int = 0       # 1: in the metrics' trace, 2: the breakdown's


@dataclasses.dataclass
class Run:
    """What a run measured, which the metric readers read."""

    steps: list
    t0: float
    t_end: float
    setup_s: float
    width: int
    height: int
    trace: object = None         # devtrace.Trace of the profiled steps
    counted: dict | None = None  # the counted frames' work (view.count)


class _HostEvent:
    """A CUDA event's stand-in on the CPU, where every copy is done when
    it returns."""

    def record(self):
        pass

    def query(self):
        return True

    def synchronize(self):
        pass


class Pipeline:
    """Steps in flight, their host buffers and events."""

    def __init__(self, shape, depth: int, device):
        import torch
        self.cuda = torch.device(device).type == "cuda"
        self.bufs = [torch.empty(shape, dtype=torch.int32,
                                 pin_memory=self.cuda)
                     for _ in range(depth)]
        self.events = [torch.cuda.Event() if self.cuda else _HostEvent()
                       for _ in range(depth)]
        self.depth = depth
        self.flight: list = []     # (Step, slot, on_land)

    def submit(self, step: Step, fb, on_land) -> None:
        """Copy step's fb to its host buffer, non-blocking, and record
        its event; before that, land the step whose buffer it reuses."""
        if len(self.flight) == self.depth:
            self.land_oldest()
        slot = step.j % self.depth
        self.bufs[slot].copy_(fb, non_blocking=self.cuda)
        self.events[slot].record()
        self.flight.append((step, slot, on_land))
        self.poll()

    def _landed(self, rec, now) -> None:
        step, slot, on_land = rec
        if not step.t_land:
            step.t_land = now
            if on_land is not None:
                on_land(step, self.bufs[slot])

    def poll(self) -> None:
        """Stamp the steps in flight whose event is done, oldest first."""
        for rec in self.flight:
            if rec[0].t_land:
                continue
            if not self.events[rec[1]].query():
                break
            self._landed(rec, time.perf_counter())

    def land_oldest(self) -> None:
        rec = self.flight.pop(0)
        if not rec[0].t_land:
            self.events[rec[1]].synchronize()
            self._landed(rec, time.perf_counter())

    def drain(self) -> None:
        while self.flight:
            self.land_oldest()


class Reservoir:
    """A uniform sample of `m` of the window's steps, drawn from the
    seed while they are issued; keeps each chosen step's landed
    framebuffer and its depth tensor."""

    def __init__(self, m: int, rng):
        self.m, self.rng = m, rng
        self.kept: dict[int, dict] = {}
        self.seen = 0

    def offer(self, j: int, zbuf) -> bool:
        self.seen += 1
        if len(self.kept) < self.m:
            self.kept[j] = {"z": zbuf}
            return True
        r = int(self.rng.integers(0, self.seen))
        if r < self.m:
            del self.kept[sorted(self.kept)[r]]
            self.kept[j] = {"z": zbuf}
            return True
        return False

    def landed(self, step: Step, buf) -> None:
        if step.j in self.kept:
            self.kept[step.j]["fb"] = buf.numpy().copy()


def run_window(traffic, pipe: Pipeline, seconds: float, start: int,
               sample: Reservoir | None, profile_steps: int = 0,
               device="cuda", min_steps: int = 0):
    """Drive steps start, start + 1, ... for `seconds`, and for at
    least min_steps.  With profile_steps, a quarter into the window,
    profile that many steps with the device's activity alone (the
    metrics' trace), then a few with the host's too (the breakdown's,
    whose host events name what the host did in each idle gap).
    Returns (steps, t0, t_end, traces): traces None or (metrics' trace,
    breakdown's trace)."""
    import torch
    from torch.profiler import record_function
    steps: list[Step] = []
    traces = None
    t0 = time.perf_counter()
    j = start
    profile_at = t0 + 0.25 * seconds if profile_steps else None

    def one(j, profiled=0):
        with record_function("portbench.inputs"):
            inputs = traffic.inputs(j)
        st = Step(j=j, t_issue=time.perf_counter(), profiled=profiled)
        with record_function("portbench.issue"):
            fb, z = traffic.issue(inputs)
        st.t_ret = time.perf_counter()
        kept = sample is not None and sample.offer(j, z)
        with record_function("portbench.readback"):
            pipe.submit(st, fb, sample.landed if kept else None)
        steps.append(st)

    while True:
        now = time.perf_counter()
        if profile_at is not None and now >= profile_at:
            profile_at = None
            n_host = min(4, profile_steps)
            traces = (_profile(one, pipe, j, profile_steps, device, 1),
                      _profile(one, pipe, j + profile_steps, n_host,
                               device, 2))
            j += profile_steps + n_host
            continue
        if now - t0 >= seconds and profile_at is None \
                and len(steps) >= min_steps:
            break
        one(j)
        j += 1
    pipe.drain()
    t_end = max(s.t_land for s in steps)
    if device != "cpu":
        torch.cuda.synchronize()
    return steps, t0, t_end, traces


def _profile(one, pipe: Pipeline, j: int, n: int, device, which: int):
    """Profile steps j .. j + n - 1 from an empty pipeline to a drained
    one, with the device's activity alone (which 1) or the host's too
    (which 2); the devtrace.Trace of them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from .devtrace import Trace
    pipe.drain()
    acts = [ProfilerActivity.CPU] if which == 2 or device == "cpu" else []
    if device != "cpu":
        torch.cuda.synchronize()
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        for k in range(n):
            one(j + k, profiled=which)
        pipe.drain()
    return Trace.from_profile(prof, n)


def check(traffic, sample: Reservoir, rw, check_pixels: int,
          rng) -> dict:
    """Each kept step's delivered framebuffer and depth against the
    reference's, at check_pixels pixels of each drawn from the seed (0:
    all), the frames traced in one plain call.  Returns the numbers
    compared (value, limit and whether it holds) and the number of
    pixels checked."""
    import torch
    n = traffic.width * traffic.height
    kept = [(j, got) for j, got in sorted(sample.kept.items())
            if "fb" in got]
    idxs = [np.sort(rng.choice(n, check_pixels, replace=False))
            if 0 < check_pixels < n else np.arange(n) for _ in kept]
    want = traffic.reference(rw, [
        (traffic.inputs(j), torch.from_numpy(idx.astype(np.int64)))
        for (j, _), idx in zip(kept, idxs)]) if kept else []
    fb_off = z_off = 0
    for (j, got), idx, (want_fb, want_z) in zip(kept, idxs, want):
        fb = got["fb"].reshape(-1)[idx]
        z = got["z"].reshape(-1)[idx].view(np.int32)
        fb_off += int(np.count_nonzero(fb != want_fb.cpu().numpy()))
        z_off += int(np.count_nonzero(
            z != want_z.cpu().contiguous().view(torch.int32).numpy()))
    frames = len(kept)
    return ({"frames_checked": {"value": frames, "limit": sample.m,
                                "holds": frames >= sample.m},
             "fb_px_off": {"value": fb_off, "limit": 0,
                           "holds": fb_off == 0},
             "zbuf_px_off": {"value": z_off, "limit": 0,
                             "holds": z_off == 0}},
            sum(len(i) for i in idxs))


def make_traffic(config: dict, traffic: dict, root: str, seed: int):
    kind = importlib.import_module(f"portbench.traffic.{traffic['kind']}")
    return kind.View(traffic, config, root, seed)


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device="cuda", root: str | None = None, t_process=None,
             overrides: dict | None = None, issue=None,
             min_steps: int = 0, log=print) -> dict:
    """One run of `workload`: the result object (see run.py).  overrides
    replace traffic parameters (tests shrink the frame on the CPU);
    issue, when given, takes the program's place: issue(traffic, inputs)
    -> (fb, zbuf) (the control and the fault tests); min_steps: the
    fewest steps the window delivers, whatever its length."""
    import torch
    t_process = time.perf_counter() if t_process is None else t_process
    root = root or os.getcwd()
    bench, cell, config, params = load_cell(root, workload)
    params = {**params, **(overrides or {})}
    seed = int(seed) % 2 ** 63
    rng = np.random.default_rng(seed)
    tr = make_traffic(config, params, root, seed)
    t_world = time.perf_counter()
    tr.setup(device)
    t_warm = time.perf_counter()
    if issue is not None:
        tr.issue = lambda inputs: issue(tr, inputs)
    depth = int(params["in_flight"])
    pipe = Pipeline((tr.height, tr.width), depth, device)
    # warm-up: every shape the window uses, through the same pipeline
    warm = int(params["warmup_steps"])
    for j in range(-warm, 0):
        st = Step(j=j, t_issue=time.perf_counter())
        fb, _ = tr.issue(tr.inputs(j))
        pipe.submit(st, fb, None)
    pipe.drain()
    if device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_process
    log(f"portbench: set-up {setup_s:.3f} s: imports "
        f"{t_world - t_process:.3f} s, the world and the CUDA context "
        f"{t_warm - t_world:.3f} s, the kernels' build or load and {warm} "
        f"warm-up steps {setup_s - (t_warm - t_process):.3f} s",
        file=sys.stderr)

    sample = Reservoir(int(params["check_frames"]), rng)
    prof_n = int(params["profile_steps"]) if trace else 0
    steps, t0, t_end, traces = run_window(tr, pipe, seconds, 0, sample,
                                          prof_n, device, min_steps)
    dtrace, htrace = traces if traces else (None, None)
    if dtrace is not None and device != "cpu" and not dtrace.device:
        log("portbench: the profiler recorded no device event",
            file=sys.stderr)
    mem = (torch.cuda.max_memory_allocated() if device != "cpu" else 0)
    counted_steps = [s.j for s in steps if s.profiled == 1][
        :int(params["count_steps"])] if trace else []
    count_inputs = [tr.inputs(j) for j in counted_steps]
    for got in sample.kept.values():
        got["z"] = got["z"].cpu().numpy()
    tr.release()
    del pipe
    if device != "cpu":
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    rw = tr.ref_world(device)
    checks, pixels = check(tr, sample, rw, int(params["check_pixels"]), rng)
    counted = tr.count(rw, count_inputs) if count_inputs else None
    del rw
    log(f"portbench: reference check {time.perf_counter() - t_check:.1f} s "
        f"({pixels} pixels, {len(count_inputs)} frames "
        f"counted)", file=sys.stderr)

    run = Run(steps=steps, t0=t0, t_end=t_end, setup_s=setup_s,
              width=tr.width, height=tr.height, trace=dtrace,
              counted=counted)
    metrics = {}
    for m in cell_metrics(bench, workload, trace):
        value = metric_reader(m["name"]).read(run)
        if value is None:
            continue
        if isinstance(value, tuple):
            value, extra = value
        else:
            extra = {}
        metrics[m["name"]] = {"value": value, "unit": m["unit"], **extra}
    if htrace is not None:
        waits = collections.Counter(
            n for n, _, _ in htrace.host
            if n in ("cudaStreamSynchronize", "cudaEventSynchronize",
                     "cudaMemcpyAsync", "cudaDeviceSynchronize"))
        log(f"portbench: host calls a step in the host-traced steps: "
            f"{ {k: v / htrace.steps for k, v in sorted(waits.items())} }",
            file=sys.stderr)
    if steps:
        per_s = np.bincount([int(s.t_issue - t0) for s in steps])
        lat = np.array([(s.t_land - s.t_issue) * 1e3 for s in steps])
        log(f"portbench: {len(steps)} steps, a second each: "
            f"{per_s.tolist()}; latency ms median {np.median(lat):.4f} "
            f"max {lat.max():.4f}", file=sys.stderr)
    correct = all(c["holds"] for c in checks.values())
    result = {"correct": correct, "attempted": len(steps),
              "failed": sum(1 for s in steps if not s.t_land),
              "metrics": metrics}
    result["device"] = device_info(device, int(cell["chips"]), mem, dtrace)
    if dtrace is not None and dtrace.device:
        result["breakdown"] = {"device_ops": dtrace.top_ops(),
                               "idle_gaps": htrace.top_gaps()}
    result["checks"] = {k: {"value": v["value"], "limit": v["limit"]}
                        for k, v in checks.items()}
    return result


def device_info(device, chips: int, mem: int, dtrace) -> dict:
    """The result's device: the card's name, the cards used, the peak
    memory, and with a trace the profiled steps' busy time and span."""
    import torch
    if device == "cpu":
        info = {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    else:
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": chips, "memory_peak_bytes": int(mem)}
    if dtrace is not None:
        info["busy_s"] = dtrace.busy_us() * 1e-6
        info["window_s"] = dtrace.span_us() * 1e-6
    return info
