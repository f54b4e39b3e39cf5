"""decode_group_s: seconds a search in the program's stage ``decode+group``:
the Python loop of ``_group_epilogue`` that builds the flank groups from
the decoded survivor rows.  The pull of those rows is stage ``pull``, read
by no metric; their decode (``dna.decode_bits``) is stage ``decode``, read
by ``decode_s``."""

from benchmark.stages import per_search


def read(run):
    return per_search(run, ["decode+group"])
