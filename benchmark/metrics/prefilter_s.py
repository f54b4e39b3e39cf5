"""prefilter_s: seconds a search in the prefix prefilter and its gather
(stages ``prefilter`` and ``gather``), which run on wide keys only."""

from benchmark.stages import per_search


def read(run):
    return per_search(run, ["prefilter", "gather"])
