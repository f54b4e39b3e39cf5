"""Small copies of the benchmark's configurations for the CPU tests: the
same windows, flags and traffic, genomes of ``bases`` letters."""

from __future__ import annotations

import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
CONFIGS = ("spacer-5x40Mb", "amplicon-5x40Mb")
TRAFFIC = ("distant", "related", "iupac")


def config(name: str, bases: int = 60_000) -> dict:
    c = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    c["genome_bases"] = bases
    return c


def traffic(name: str) -> dict:
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())
