"""Reading the profiler's trace of the profiled steps.

The busy-union arithmetic is copied from pwnfps_tpu_torch/profile_frame.py
(`_busy_us`): the device is busy where any kernel, copy or memset runs,
and the idle share of a span is 1 - busy / span.
"""

from __future__ import annotations

import dataclasses

# what each device operation belongs to, by its name: the tracer's
# kernels (csrc/tracer_body.cuh trace_kernel), the blur's (csrc/blur.cu
# dof_blur_tiles), the framebuffer's copy to the host, and the frame
# glue (every other kernel, copy and memset)
TRACER, BLUR, READBACK, GLUE = "tracer", "blur", "readback", "glue"
# the prefix of the harness's own record_function ranges: the profiler
# lists each also as a device-side range, which is no device work
ANNOTATION = "portbench."


def kind(name: str) -> str:
    if "trace_kernel" in name:
        return TRACER
    if "dof_blur" in name:
        return BLUR
    if name.startswith("Memcpy DtoH"):
        return READBACK
    return GLUE


def busy_us(spans) -> float:
    """Length of the union of [start, end) intervals."""
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


def idle_gaps(spans) -> list[tuple[float, float]]:
    """The [start, end) intervals inside the spans' extent that no span
    covers, in order."""
    out, cur_e = [], None
    for s, e in sorted(spans):
        if cur_e is not None and s > cur_e:
            out.append((cur_e, s))
        cur_e = e if cur_e is None else max(cur_e, e)
    return out


@dataclasses.dataclass
class Trace:
    """The device and host events of `steps` profiled steps, in us on the
    profiler's one clock: (name, start, end) each."""

    device: list
    host: list
    steps: int

    @classmethod
    def from_profile(cls, prof, steps: int) -> "Trace":
        import torch
        dev_type = torch.autograd.DeviceType.CUDA
        device, host = [], []
        for e in prof.events():
            rec = (e.name, float(e.time_range.start),
                   float(e.time_range.end))
            if e.device_type != dev_type:
                host.append(rec)
            elif not e.name.startswith(ANNOTATION):
                device.append(rec)
        return cls(device=device, host=host, steps=steps)

    def span_us(self) -> float:
        if not self.device:
            return 0.0
        return (max(e for _, _, e in self.device)
                - min(s for _, s, _ in self.device))

    def busy_us(self) -> float:
        return busy_us([(s, e) for _, s, e in self.device])

    def us(self, what: str) -> float:
        """Device us of the operations of one kind, summed."""
        return sum(e - s for n, s, e in self.device if kind(n) == what)

    def count(self, what: str) -> int:
        return sum(1 for n, _, _ in self.device if kind(n) == what)

    def tracer_us_each(self) -> list[float]:
        """Each tracer launch's device us, in launch order."""
        return [e - s for n, s, e in sorted(self.device, key=lambda r: r[1])
                if kind(n) == TRACER]

    def top_ops(self, n: int = 10) -> list:
        """[[name, seconds]] of the n device operations (by name) that
        took most time."""
        per: dict[str, float] = {}
        for name, s, e in self.device:
            per[name] = per.get(name, 0.0) + (e - s)
        top = sorted(per.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:120], us * 1e-6] for name, us in top]

    def top_gaps(self, n: int = 10) -> list:
        """[[what the host was doing, seconds]] of the n longest idle
        gaps of the device: the innermost host event that covers a gap's
        midpoint, or "host: no traced call"."""
        gaps = sorted(idle_gaps([(s, e) for _, s, e in self.device]),
                      key=lambda g: g[0] - g[1])[:n]
        out = []
        for g0, g1 in gaps:
            mid = 0.5 * (g0 + g1)
            inner = None
            for name, s, e in self.host:
                if s <= mid < e and (inner is None or s > inner[1]):
                    inner = (name, s)
            label = inner[0] if inner else "host: no traced call"
            out.append([label[:120], (g1 - g0) * 1e-6])
        return out
