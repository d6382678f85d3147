"""step_ms: the window's wall time over the steps it delivered, in ms."""


def read(run):
    if not run.steps:
        return None
    return (run.t_end - run.t0) * 1e3 / len(run.steps)
