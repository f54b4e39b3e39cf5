"""owner_s: seconds a search in stage ``owner`` of the sharded route
(``parallel.distributed.sharded_intersect_pipeline``): each shard's sorted
rows mapped to the shards that own their keys and split into one run a
shard, and every owner's rows summed against the kernels' row limit; the
stage waits for every card at its end."""

from benchmark.stages import per_search


def read(run):
    return per_search(run, ["owner"])
