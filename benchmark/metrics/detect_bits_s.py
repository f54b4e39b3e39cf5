"""detect_bits_s: seconds a search in the program's stage ``detect_bits``:
the choice of the per-base encoding width, a byte histogram of every
genome (``engine.pipeline.detect_bits``, ``dna.choose_bits``)."""

from benchmark.stages import per_search


def read(run):
    return per_search(run, ["detect_bits"])
