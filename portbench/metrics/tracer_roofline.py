"""tracer_roofline: the least time of the counted frames' traces
over the tracer's device time on those frames, in %.

The counted frames are the first `count_steps` of the profiled steps;
the reference traced each of them in full and counted its work
(steps, segments, sphere or slot tests), and peaks.trace_bound_ms turns
the counts into the larger of operations over 67 TFLOP/s and bytes over
3.35 TB/s.  Their kernels are the first launches of the profiled steps,
in order, at the same number of launches a step."""

from portbench.peaks import trace_bound_ms


def read(run):
    t, c = run.trace, run.counted
    if t is None or not c:
        return None
    each = t.tracer_us_each()
    if not each or len(each) % t.steps:
        return None
    used = each[:len(each) // t.steps * c["frames"]]
    bound_ms, bound_by, _ = trace_bound_ms(c["counts"], c["parity"],
                                           c["rays"])
    return 100.0 * bound_ms / (sum(used) * 1e-3), {"bound_by": bound_by}
