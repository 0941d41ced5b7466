"""setup_s: from the process's start to the first timed request: imports,
the card's context, the kernels' build on a checkout's first run, the
cell's inputs and its warm-up."""


def read(window):
    return window.setup_s
