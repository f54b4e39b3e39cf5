"""Output renderers for the k-mer engine: alignment text and CSV rows.

Byte-format parity targets:
  - alignment text + diagnostic bracket:
    reference src/krisp/krisp_fasta/Amplicon.py:523-661
  - CSV rows/header: Amplicon.py:663-671,
    outputAlignments.py:26-31 (header), README.md:118-124 (expected output)
  - primer statistics tables: Amplicon.py:566-595 (PrettyTable border=False,
    left-aligned — reproduced by ``simple_table`` below).
"""

from __future__ import annotations

from .groups import FlankGroup

PRIMER3_COL_NAMES = [
    'PRIMER_PAIR_0_PRODUCT_SIZE',
    'PRIMER_PAIR_0_PENALTY',
    'PRIMER_LEFT_0_SEQUENCE', 'PRIMER_RIGHT_0_SEQUENCE',
    'PRIMER_LEFT_0_PENALTY', 'PRIMER_RIGHT_0_PENALTY',
    'PRIMER_LEFT_0_TM', 'PRIMER_RIGHT_0_TM',
    'PRIMER_LEFT_0_GC_PERCENT', 'PRIMER_RIGHT_0_GC_PERCENT',
    'PRIMER_LEFT_0_SELF_ANY_TH', 'PRIMER_RIGHT_0_SELF_ANY_TH',
    'PRIMER_LEFT_0_SELF_END_TH', 'PRIMER_RIGHT_0_SELF_END_TH',
    'PRIMER_LEFT_0_HAIRPIN_TH', 'PRIMER_RIGHT_0_HAIRPIN_TH',
    'PRIMER_LEFT_0_END_STABILITY', 'PRIMER_RIGHT_0_END_STABILITY',
    'PRIMER_PAIR_0_COMPL_ANY_TH', 'PRIMER_PAIR_0_COMPL_END_TH',
]
PRIMER3_COL_KEY = {n: n.replace("PRIMER_", "").replace("_0", "").lower()
                   for n in PRIMER3_COL_NAMES}


def format_p3_output(p3_out: dict) -> dict:
    """Best-pair stats keyed for CSV (parity: Amplicon.py:99-101)."""
    return {PRIMER3_COL_KEY[n]: p3_out[n] for n in PRIMER3_COL_NAMES}


def csv_header(primer3: bool = False, sep: str = ",") -> str:
    names = ["left_seq", "diag_seq", "right_seq"]
    if primer3:
        names += [PRIMER3_COL_KEY[n] for n in PRIMER3_COL_NAMES]
    return sep.join(names)


def render_csv(group: FlankGroup, sep: str = ",") -> str:
    if len(group.amplicons) == 1:
        values = list(group.consensus().values())
    else:
        values = list(group.ingroup_consensus().values())
    if group.p3 is not None:
        values.extend(format_p3_output(group.p3).values())
    return sep.join(str(v) for v in values)


def simple_table(field_names, rows, align="l") -> str:
    """PrettyTable ``get_string(border=False)`` work-alike: one space of
    padding each side of every left-aligned cell, trailing spaces kept."""
    widths = [len(str(f)) for f in field_names]
    for row in rows:
        for i, v in enumerate(row):
            widths[i] = max(widths[i], len(str(v)))
    def fmt(row):
        return "".join(" " + str(v).ljust(w) + " " for v, w in zip(row, widths))
    lines = [fmt(field_names)]
    lines += [fmt(r) for r in rows]
    return "\n".join(lines)


def _stats_by_role(p3: dict) -> dict:
    """Best-pair statistics keyed by role: ``{'LEFT': {stat: value}, …}``,
    preserving p3 insertion order.  A key contributes when it has the
    shape PRIMER_<role>_0_<stat>; bare position keys (PRIMER_LEFT_0) and
    other indices do not."""
    out = {"LEFT": {}, "RIGHT": {}, "PAIR": {}}
    for key, val in p3.items():
        role, sep, stat = key.removeprefix("PRIMER_").partition("_0_")
        if sep and stat and role in out:
            out[role][stat] = val
    return out


def _stat_name(stat: str) -> str:
    return stat.title().replace("_", " ")


def _stat_cell(value):
    return str(round(value, 5)) if isinstance(value, float) else value


def render_primer3_stats(p3: dict) -> str:
    """Primer/pair statistics tables.  Byte-format target:
    Amplicon.py:566-595 (PrettyTable border=False; forward and reverse
    stats share the forward row's column names positionally)."""
    stats = _stats_by_role(p3)
    primer_tbl = simple_table(
        ["Direction", *map(_stat_name, stats["LEFT"])],
        [["Forward", *map(_stat_cell, stats["LEFT"].values())],
         ["Reverse", *map(_stat_cell, stats["RIGHT"].values())]])
    pair_tbl = simple_table([*map(_stat_name, stats["PAIR"])],
                            [[*map(_stat_cell, stats["PAIR"].values())]])
    return ("\nPrimer statistics:\n" + primer_tbl
            + "\n\nPair statistics:\n" + pair_tbl)


def make_bracket(group: FlankGroup) -> str:
    """`{--*--#}` diagnostic bracket under the alignment: one glyph per
    column of the diagnostic window — ``{``/``}`` at the frame (the
    ``{`` sits one column left of the window, a quirk the goldens pin),
    ``*`` diagnostic, ``#`` ingroup-unique, ``-`` filler
    (byte-format target: Amplicon.py:523-540)."""
    lo = len(group.left)
    width = len(group.amplicons[0].mid)
    glyph = {-1: "{", width: "}"}
    glyph.update((c, "*") for c in group.diagnostic_columns())
    glyph.update((c, "#") for c in group.ingroup_unique_columns())
    return " " * (lo - 1) + "".join(
        glyph.get(c, "-") for c in range(-1, width + 1))


def _amplicon_rows(group: FlankGroup) -> list:
    """Alignment body rows: amplicons in label order; when an ingroup is
    set, rows sharing a label with it float to the top (stable)."""
    ranked = sorted(group.amplicons, key=lambda a: a.labels)
    if group.ingroup is not None:
        members = set(group.ingroup)
        ranked = sorted(ranked, key=lambda a: not (set(a.labels) & members))
    return [str(a) for a in ranked]


def _dot_mask(rows: list, width: int) -> list:
    """Replace bases matching the top row with '.' within the alignment
    width; columns past the width (annotations) pass through."""
    top = rows[0]
    return [top] + [
        "".join("." if row[c] == top[c] else row[c]
                for c in range(width)) + row[width:]
        for row in rows[1:]]


def _primer_lane(p3: dict) -> str:
    """`└─Forward─┘ … └─Reverse─┘` lane, each tag as wide as its primer
    and starting at the primer's template position.  The inter-tag gap is
    measured from the forward primer's length, not the tag width — for
    primers shorter than the label the tag overflows rightward without
    shifting the reverse tag (reference quirk, Amplicon.py:638-642)."""
    def tag(word, seq):
        return "└" + word.center(len(seq) - 2, "─") + "┘"

    fwd_seq = p3["PRIMER_LEFT_0_SEQUENCE"]
    fwd_at = p3["PRIMER_LEFT_0"][0]
    rev_at = p3["PRIMER_RIGHT_0"][0] - p3["PRIMER_RIGHT_0"][1]
    return (" " * fwd_at + tag("Forward", fwd_seq)
            + " " * (rev_at - fwd_at - len(fwd_seq) + 1)
            + tag("Reverse", p3["PRIMER_RIGHT_0_SEQUENCE"]))


def _merge_lane(bottom: str, lane: str) -> str:
    """Overlay the primer lane onto the bracket row: lane glyphs fill the
    bracket's blank columns, bracket glyphs win elsewhere."""
    padded = bottom.ljust(len(lane))
    return "".join(l if b == " " else b for b, l in zip(padded, lane))


def render_alignment(group: FlankGroup, enable_dot: bool = False) -> str:
    """Human-readable alignment for one flank group: body rows, then
    either a dot-masked body or the diagnostic bracket, then the primer
    lane (a separate row in dot mode, merged into the bracket otherwise)
    and the statistics tables (byte-format target: Amplicon.py:598-661)."""
    rows = _amplicon_rows(group)
    if enable_dot:
        rows = _dot_mask(rows, len(group.amplicons[0].sequence))
    else:
        rows.append(make_bracket(group))
    if group.p3 is not None:
        lane = _primer_lane(group.p3)
        if enable_dot:
            rows.append(lane)
        else:
            rows[-1] = _merge_lane(rows[-1], lane)
        rows.append(render_primer3_stats(group.p3))
    rows[-1] += "\n"
    return "\n".join(rows)
