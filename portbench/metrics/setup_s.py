"""setup_s: from the start of the run's process to the start of the
window: imports, the CUDA context, the kernels' build or load, the
world's build and the warm-up steps, in s."""


def read(run):
    return run.setup_s
