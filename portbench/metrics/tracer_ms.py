"""tracer_ms: device ms a step of the tracer's kernels, over the
profiled steps."""

from portbench.devtrace import TRACER


def read(run):
    t = run.trace
    if t is None or not t.count(TRACER):
        return None
    return t.us(TRACER) * 1e-3 / t.steps
