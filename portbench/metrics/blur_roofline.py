"""blur_roofline: the DoF passes' least time (12 B a pixel and the
jump table over HBM's 3.35 TB/s, a pass) over the blur kernel's device
time, in %, over the profiled steps."""

from portbench.devtrace import BLUR
from portbench.peaks import blur_bound_ms


def read(run):
    t = run.trace
    if t is None or not t.count(BLUR):
        return None
    bound = blur_bound_ms(run.width, run.height) * t.count(BLUR)
    return 100.0 * bound / (t.us(BLUR) * 1e-3), {"bound_by": "bytes"}
