"""stack_s: seconds a search in the program's stage ``stack``: the genomes
copied into one zero-padded array (``engine.pipeline._stack``)."""

from benchmark.stages import per_search


def read(run):
    return per_search(run, ["stack"])
