"""exchange_s: seconds a search in stage ``exchange`` of the sharded route
(``parallel.distributed.sharded_intersect_pipeline``): every shard's rows
sent to the shards that own their keys, card to card; the stage waits for
every card at its end."""

from benchmark.stages import per_search


def read(run):
    return per_search(run, ["exchange"])
