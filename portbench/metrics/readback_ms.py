"""readback_ms: device ms a step of the framebuffer's copy to the host,
over the profiled steps."""

from portbench.devtrace import READBACK


def read(run):
    t = run.trace
    if t is None or not t.count(READBACK):
        return None
    return t.us(READBACK) * 1e-3 / t.steps
