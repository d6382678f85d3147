"""glue_device_ms: device ms a step of every kernel, copy and memset
that is neither the tracer's, nor the blur's, nor the framebuffer's
readback (the frame glue), over the profiled steps."""

from portbench.devtrace import GLUE


def read(run):
    t = run.trace
    if t is None or not t.device:
        return None
    return t.us(GLUE) * 1e-3 / t.steps
