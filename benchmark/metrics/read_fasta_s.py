"""read_fasta_s: seconds a search in stage ``read_fasta`` (io.fasta,
io.native)."""

from benchmark.stages import per_search


def read(run):
    return per_search(run, ["read_fasta"])
