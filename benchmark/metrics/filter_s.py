"""filter_s: seconds a search in the program's stage ``filter``: the
diagnostic ingroup filter over the flank groups
(``engine.groups.FlankGroup.ingroup_unique_columns``)."""

from benchmark.stages import per_search


def read(run):
    return per_search(run, ["filter"])
