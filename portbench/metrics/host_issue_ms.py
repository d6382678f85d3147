"""host_issue_ms: host ms a step spends inside the program's entry call,
on the host clock, over every step of the window outside the profiled
ones (the profiler would inflate them)."""


def read(run):
    ms = [(s.t_ret - s.t_issue) * 1e3 for s in run.steps if not s.profiled]
    return sum(ms) / len(ms) if ms else None
