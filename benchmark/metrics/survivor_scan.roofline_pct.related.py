"""survivor_scan.roofline_pct.related: ``survivor_scan.roofline_pct``'s reader,
for the related cell.  There the search's rate is a per-layer metric
(``kmers_per_s.related``), its runs spreading past what a bound can hold,
and every per-layer metric moves ``setup_s``, which holds a warm-up search
(README.md)."""

from benchmark.harness import load_reader

read = load_reader("survivor_scan.roofline_pct")
