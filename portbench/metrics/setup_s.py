"""Set-up: from the process's start to the window's, on the host clock
(weights, the kernels' build on a checkout's first run, the engine and
its captured decode step, the warm-up, the GEM plan and its install)."""


def read(run):
    return run.setup_s
