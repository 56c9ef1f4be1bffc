"""setup_s: process start to the first frame handed over (host clock):
imports, the card's context, loading or building the kernels, making the
frame pool, and the warm-up of the cell's own shapes."""


def read(run):
    return run.setup_s
