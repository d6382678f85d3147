"""idle_pct: the share of the profiled steps' device span (first device
operation's start to the last one's end) in which no kernel, copy or
memset ran, in %: 1 - busy / span (profile_frame's arithmetic)."""


def read(run):
    t = run.trace
    if t is None or not t.device:
        return None
    span = t.span_us()
    return 100.0 * (1.0 - t.busy_us() / span) if span > 0 else None
