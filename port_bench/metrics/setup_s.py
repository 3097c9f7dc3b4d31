"""setup_s: seconds from the process's start to the window's start
(imports, CUDA init, checkpoints, inputs, warm-up; on a checkout's first
run, the kernels' build too). Host clock."""


def read(run):
    return run.setup_s if run.setup_s > 0 else None
