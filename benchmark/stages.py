"""Per-search readings of the program's stages (``krisp_tpu_torch``'s
``metrics.GLOBAL``, reset at the window's start), for the metric
readers."""

from __future__ import annotations


def stage_sum(run, names, key: str = "seconds") -> float | None:
    """``key`` of the named stages summed over the window; None where none
    of them ran."""
    hit = [run.stages[n][key] for n in names if n in run.stages]
    return sum(hit) if hit else None


def per_search(run, names) -> float | None:
    """Seconds a search in the named stages; None where none of them
    ran."""
    total = stage_sum(run, names)
    if total is None or not run.searches:
        return None
    return total / len(run.searches)
