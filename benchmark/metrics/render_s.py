"""render_s: seconds a search in the program's stage ``render``: the CSV
and alignment rendered, written and closed (``cli.krisp_fasta``,
``engine.render``)."""

from benchmark.stages import per_search


def read(run):
    return per_search(run, ["render"])
