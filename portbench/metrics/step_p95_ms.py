"""step_p95_ms: the 95th percentile, over every step of the window, of
the time from the step's issue to its framebuffer on the host, in ms
(numpy's linear interpolation between order statistics)."""

import numpy as np


def read(run):
    lat = [(s.t_land - s.t_issue) * 1e3 for s in run.steps]
    return float(np.percentile(lat, 95)) if lat else None
