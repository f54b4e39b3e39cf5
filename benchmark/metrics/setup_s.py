"""setup_s: process start to window start: imports, the CUDA context, the
kernel library (built on a checkout's first run), the genomes and one
warm-up search."""


def read(run):
    return run.setup_s
