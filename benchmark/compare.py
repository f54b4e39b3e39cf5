"""The comparison that decides ``correct``: the texts each search wrote
against the plain reference's, exact.

Each number is compared with its limit as ``value <= limit``; every limit
here is 0, an exact comparison (PERF.md gives the readings behind them).
"""

from __future__ import annotations

LIMITS = {"searches_wrong": 0, "csv_lines_wrong": 0,
          "alignment_lines_wrong": 0}


def lines_wrong(got: str | None, want: str) -> int:
    """Lines that differ by position, plus the lines one text has beyond
    the other; a text never written counts every line of the reference
    and one more."""
    want_lines = want.split("\n")
    if got is None:
        return len(want_lines) + 1
    got_lines = got.split("\n")
    return (sum(a != b for a, b in zip(got_lines, want_lines))
            + abs(len(got_lines) - len(want_lines)))


def compare(outputs, want_csv: str, want_align: str) -> dict:
    """{name: value} over every search's (csv, alignment) texts."""
    csv = [lines_wrong(c, want_csv) for c, _ in outputs]
    align = [lines_wrong(a, want_align) for _, a in outputs]
    return {"searches_wrong": sum(c + a > 0 for c, a in zip(csv, align)),
            "csv_lines_wrong": max(csv, default=0),
            "alignment_lines_wrong": max(align, default=0)}


def checks(values: dict) -> dict:
    """The result line's ``checks``: each number beside its limit."""
    return {k: {"value": v, "limit": LIMITS[k]} for k, v in values.items()}


def passed(values: dict) -> bool:
    return all(v <= LIMITS[k] for k, v in values.items())
