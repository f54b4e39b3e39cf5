"""Column-model multi-group alignment renderer for krisp_vcf output.

Byte-format parity with the reference's print_align module
(reference src/krisp/krisp_vcf/print_align.py:6-257), re-expressed
as a prefix-sum column-geometry pipeline: every layout decision — cell
widths, pad characters, bracket spans, line wrapping — is derived once
from integer prefix-sum arrays and applied by slicing, instead of the
reference's per-cell dict mutation and iterator threading.

Reference quirks the byte goldens depend on, preserved deliberately:
  - the oligo overlay row is BUILT with one slot per reference character
    (print_align.py:178-196) but padded and printed with one slot per
    COLUMN; surplus tail slots are dropped by zip truncation at wrap time;
  - base-position -> column lookup collapses duplicate stripped-prefix
    ends onto the LAST column (the ``{end-1: col}`` dict rebuild of
    print_align.py:48-52);
  - every wrapped block repeats the FULL bracket row (print_align.py:139);
  - block ids that skip an integer shift which blocks print: blocks are
    looked up by consecutive index over the COUNT of distinct ids
    (print_align.py:171-174);
  - out-of-grid oligo spans raise IndexError/TypeError — the caller turns
    that into "CANNOT PRINT ALIGNMENT WITH OVERLAPPING INDELS"
    (krisp_vcf.py:1160-1167), so bounds are indexed, never guarded.
"""

from __future__ import annotations

import bisect
import shutil

from ..engine.render import simple_table


class Annotation:
    """An oligo overlaid on the alignment at a 0-based base position."""

    def __init__(self, name, seq, start):
        self.name = name
        self.seq = seq
        self.start = start


def _ends(widths):
    """Inclusive prefix sums: ends[i] = total width through column i."""
    out, total = [], 0
    for w in widths:
        total += w
        out.append(total)
    return out


def _stripped_ends(cells):
    return _ends([len(c.strip()) for c in cells])


def _column_of(pos, ends):
    """Column owning base position ``pos`` under inclusive stripped ends:
    the smallest end exceeding ``pos`` wins, and duplicate ends collapse
    onto the last column sharing that end (reference dict-rebuild
    semantics).  None when ``pos`` is past the grid."""
    j = bisect.bisect_right(ends, pos)
    if j == len(ends):
        return None
    return bisect.bisect_right(ends, ends[j]) - 1


def dot_masked(row, ref):
    """Ref-equal cells become dots sized to the reference cell."""
    return ["." * len(ref[i]) if row[i] == ref[i] else row[i]
            for i in range(len(row))]


def oligo_row(annots, ref):
    """Overlay row with one slot per reference CHARACTER.  The write
    cursor starts at the owning COLUMN index and advances one slot per
    oligo character — the reference's coordinate mix, kept verbatim."""
    ends = _stripped_ends(ref)
    row = [" "] * sum(len(c) for c in ref)
    for annot in annots:
        col = _column_of(annot.start, ends)
        for i, ch in enumerate(annot.seq):
            row[col + i] = ch
    return row


def _fit_columns(ref, rows):
    """Per-column geometry: width = widest cell in the column, pad = " "
    when any cell carries an annotation marker (">" or "/"), else "-"."""
    widths, pads = [], []
    for i, ref_cell in enumerate(ref):
        cells = [ref_cell] + [row[i] for row in rows.values()]
        widths.append(max(len(c) for c in cells))
        pads.append(" " if any(">" in c or "/" in c for c in cells)
                    else "-")
    return widths, pads


def _centered(row, widths, pads):
    """Center the first len(widths) slots; blank cells always pad with
    spaces; slots past the grid (oligo tail) pass through untouched."""
    out = list(row)
    for i, (w, p) in enumerate(zip(widths, pads)):
        cell = out[i]
        out[i] = cell.center(w, " " if cell == " " else p)
    return out


def bracket_row(annots, ref, widths):
    """``└─ name ─┘`` brackets, one string per column: the bracket text is
    cut into column-width pieces by slicing at the span's prefix ends."""
    row = [" " * w for w in widths]
    ends = _stripped_ends(ref)
    for annot in annots:
        lo = _column_of(annot.start, ends)
        hi = _column_of(annot.start + len(annot.seq) - 1, ends)
        span = widths[lo:hi + 1]
        text = "└" + f" {annot.name} ".center(sum(span) - 2, "─") + "┘"
        row[lo:hi + 1] = [text[e - w:e] for w, e in zip(span, _ends(span))]
    return row


def _labels(names, groups, ref_name):
    """Row labels: group rows carry their sample count."""
    counts = {g: str(len(m)) for g, m in groups.items()}
    labels = {n: f"{n} ({counts[n]})" if n in counts else f"{n}"
              for n in names}
    width = max(len(x) for x in [*labels.values(), ref_name])
    return labels, width


def _blocks(cells, ids):
    """Group cells by block id, insertion-ordered; zip truncates rows
    longer than the id array (the oligo tail)."""
    out = {}
    for cell, b in zip(cells, ids):
        out.setdefault(b, []).append(cell)
    return out


def print_align(rows, ref, annot_text, groups, ref_name="Reference"):
    """Wrap the padded grid to the terminal width and emit labeled rows;
    each block ends with the (full) bracket row."""
    term_width = shutil.get_terminal_size().columns
    gutter = max(len(n) for n in [*rows, ref_name])
    align_width = term_width - gutter - 5
    ids = [e // align_width for e in _ends([len(c) for c in ref])]

    ref_blocks = _blocks(ref, ids)
    row_blocks = {n: _blocks(r, ids) for n, r in rows.items()}
    labels, width = _labels(list(rows), groups, ref_name)
    bracket = " " * (width + 2) + "".join(annot_text)

    out = []
    for b in range(len(ref_blocks)):
        out.append(f"{ref_name.rjust(width)}: "
                   + "".join(ref_blocks.get(b, [])))
        for name in rows:
            out.append(f"{labels[name].rjust(width)}: "
                       + "".join(row_blocks[name].get(b, [])))
        out.append(bracket)
    return out


def render_primer3_stats(p3):
    left = {k[14:]: v for k, v in p3.items() if "PRIMER_LEFT_0_" in k}
    right = {k[15:]: v for k, v in p3.items() if "PRIMER_RIGHT_0_" in k}
    pair = {k[14:]: v for k, v in p3.items() if "PRIMER_PAIR_0_" in k}

    def names(keys):
        return [x.title().replace("_", " ") for x in keys]

    def vals(values):
        return [str(round(x, 5)) if isinstance(x, float) else x
                for x in values]

    primer_tbl = simple_table(["Direction"] + names(left.keys()),
                              [["Forward"] + vals(left.values()),
                               ["Reverse"] + vals(right.values())])
    pair_tbl = simple_table(names(pair.keys()), [vals(pair.values())])
    return ("\nPrimer statistics:\n" + primer_tbl +
            "\n\nPair statistics:\n" + pair_tbl)


def render_variant(seqs, ref, p3, groups, annots=None):
    """Full alignment rendering (parity: print_align.py:226-257)."""
    rows = {name: dot_masked(row, ref) for name, row in seqs.items()}
    if annots is not None:
        rows["oligos"] = oligo_row(annots, ref)
    widths, pads = _fit_columns(ref, rows)
    ref_p = [c.center(w, p) for c, w, p in zip(ref, widths, pads)]
    rows_p = {n: _centered(r, widths, pads) for n, r in rows.items()}
    annot_text = bracket_row(annots, ref_p, widths)
    output = print_align(rows_p, ref_p, annot_text, groups)
    output.append(render_primer3_stats(p3))
    return output
