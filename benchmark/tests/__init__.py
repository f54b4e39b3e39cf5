"""CPU tests of the benchmark (``python -m pytest benchmark/tests -q``);
the one test marked ``cuda`` runs a cell on the card and skips without
one."""
