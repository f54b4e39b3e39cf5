"""decode_s: seconds a search in the program's stage ``decode``: the
survivor rows' flank, middle and genome id decoded on the host
(``engine.pipeline._decode_and_group``, ``dna.decode_bits``)."""

from benchmark.stages import per_search


def read(run):
    return per_search(run, ["decode"])
