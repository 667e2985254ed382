"""Set-up: from the start of the process to the window's start (imports,
the kernels' build or load, the weights, the warm-up), host clock."""


def read(run):
    return run["setup_s"]
