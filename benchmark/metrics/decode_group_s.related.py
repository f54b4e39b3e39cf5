"""decode_group_s.related: ``decode_group_s``'s reader, for the related cell.
There the search's rate is a per-layer metric (``kmers_per_s.related``), its
runs spreading past what a bound can hold, and every per-layer metric moves
``setup_s``, which holds a warm-up search (README.md)."""

from benchmark.harness import load_reader

read = load_reader("decode_group_s")
