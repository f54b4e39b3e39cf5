"""Plain reference of one ``krisp_fasta`` search, worked out again from the
FASTA files alone.

What a search promises (upstream krisp's ``krisp_fasta``):

* a window is every run of ``L = left + mid + right`` letters inside one
  record, on both strands (the reverse strand is the reverse complement);
  a window holding any letter outside the IUPAC alphabet, or an N, is
  skipped; lower case counts as upper case;
* a window's flank is its first ``left`` and last ``right`` letters, its
  middle the ``mid`` between; each genome counts its windows per (flank,
  middle);
* a flank survives when every genome holds a window with it; all of a
  surviving flank's (middle, genome, count) rows form its group;
* with a middle and an outgroup, a group is kept when some middle column
  holds no letter that both an ingroup and an outgroup window have there;
* the CSV has a row per kept group, the alignment a block per kept group,
  both in flank order, each as upstream krisp renders it.

Windows are found on the device with plain torch in blocks of one strand
of one genome: first the flanks' leading 15 letters (one int64) that
every genome holds, an exact necessary condition, then the whole flank of
the windows that pass it, grouped exactly.  The groups, the filter and the
rendering run on the host over the survivors.  ``strands`` = ("+",) is
the benchmark's control: the same search with the reverse strand left out.
"""

from __future__ import annotations

from collections import Counter
from pathlib import Path

import numpy as np
import torch

#: letters a window may hold (N is not one), in ASCII order
LETTERS = b"ABCDGHKMRSTVWY"
_PAIRS = {"A": "T", "C": "G", "G": "C", "T": "A", "R": "Y", "Y": "R",
          "S": "S", "W": "W", "K": "M", "M": "K", "B": "V", "V": "B",
          "D": "H", "H": "D", "N": "N"}
#: the IUPAC letter of each set of bases
_IUPAC = {"A": "A", "C": "C", "G": "G", "T": "T", "AC": "M", "AG": "R",
          "AT": "W", "CG": "S", "CT": "Y", "GT": "K", "ACG": "V", "ACT": "H",
          "AGT": "D", "CGT": "B", "ACGT": "N"}
PER_WORD = 15   # letters a 60-bit word of 4-bit codes holds


def _tables():
    upper = np.arange(256, dtype=np.uint8)
    upper[ord("a"):ord("z") + 1] -= 32
    code = np.full(256, 255, np.int64)
    for i, ch in enumerate(LETTERS):
        code[ch] = i
        code[ch + 32] = i
    comp = np.zeros(256, np.uint8)   # anything else: 0, never valid
    for a, b in _PAIRS.items():
        comp[ord(a)] = ord(b)
    return upper, code, comp


UPPER, CODE, COMP = _tables()


def read_fasta(path) -> np.ndarray:
    """The records of a FASTA file, upper case, joined by a 0 byte (never
    a letter, so no window crosses two records)."""
    data = Path(path).read_bytes()
    parts = []
    for rec in data.split(b">")[1:]:
        body = rec.split(b"\n", 1)[1] if b"\n" in rec else b""
        parts.append(b"".join(body.split()))
    return UPPER[np.frombuffer(b"\0".join(parts), np.uint8)]


def genome_name(path) -> str:
    return Path(path).name.split(".")[0]


class Geometry:
    def __init__(self, left: int, mid: int, right: int):
        self.left, self.mid, self.right = left, mid, right
        self.L = left + mid + right
        flank = list(range(left)) + list(range(left + mid, self.L))
        # the flank's letter offsets in a window, in words of PER_WORD
        self.words = [flank[i:i + PER_WORD]
                      for i in range(0, len(flank), PER_WORD)]


def _strand(seq: np.ndarray, strand: str, device) -> torch.Tensor:
    s = seq if strand == "+" else COMP[seq][::-1].copy()
    return torch.from_numpy(s).to(device)


def _codes(s: torch.Tensor, geom: Geometry):
    """(codes int64 with 0 at bad letters, bool valid-window flags)."""
    code = torch.from_numpy(CODE).to(s.device)[s.long()]
    bad = code == 255
    code[bad] = 0
    n_win = s.numel() - geom.L + 1
    if n_win <= 0:
        return code, torch.zeros(0, dtype=torch.bool, device=s.device)
    cb = torch.cat([bad.new_zeros(1, dtype=torch.int64),
                    torch.cumsum(bad, 0)])
    return code, (cb[geom.L:geom.L + n_win] - cb[:n_win]) == 0


def _word(code: torch.Tensor, offsets, starts) -> torch.Tensor:
    """One flank word of the windows starting at ``starts`` (a slice or
    an index tensor)."""
    w = None
    for off in offsets:
        c = (code[starts + off] if isinstance(starts, torch.Tensor)
             else code[starts.start + off:starts.stop + off])
        w = c.clone() if w is None else w * 16 + c
    return w


def survivors(seqs, geom: Geometry, device, strands=("+", "-")):
    """The windows of surviving flanks: (genome, strand, start) int64
    arrays, in no order."""
    n = len(seqs)
    common = None
    for g in range(n):   # stage 1: leading flank words every genome holds
        held = []
        for st in strands:
            code, ok = _codes(_strand(seqs[g], st, device), geom)
            w0 = _word(code, geom.words[0], slice(0, ok.numel()))
            held.append(torch.unique(w0[ok]))
            del code, ok, w0
        held = torch.unique(torch.cat(held))
        common = held if common is None else common[torch.isin(common, held)]
    words, ids = [], []
    for g in range(n):   # stage 2: whole flanks of the windows that pass
        for si, st in enumerate(strands):
            code, ok = _codes(_strand(seqs[g], st, device), geom)
            w0 = _word(code, geom.words[0], slice(0, ok.numel()))
            at = torch.nonzero(ok & torch.isin(w0, common)).squeeze(1)
            del w0, ok
            words.append(torch.stack([_word(code, offs, at)
                                      for offs in geom.words], 1))
            ids.append(torch.stack([torch.full_like(at, g),
                                    torch.full_like(at, si), at], 1))
            del code
    words, ids = torch.cat(words), torch.cat(ids)
    if words.shape[0] == 0:
        empty = np.zeros(0, np.int64)
        return empty, empty, empty
    _, flank = torch.unique(words, dim=0, return_inverse=True)
    pairs = torch.unique(flank * n + ids[:, 0])
    genomes = torch.bincount(pairs // n, minlength=int(flank.max()) + 1)
    keep = ids[(genomes == n)[flank]].cpu().numpy()
    return keep[:, 0], np.array(strands)[keep[:, 1]], keep[:, 2]


def _windows(seqs, geom: Geometry, g, strand, start) -> list[bytes]:
    rc = {}
    out = np.empty((g.size, geom.L), np.uint8)
    span = np.arange(geom.L)
    for k in np.unique(g):
        for st in ("+", "-"):
            sel = np.flatnonzero((g == k) & (strand == st))
            if sel.size == 0:
                continue
            if st == "+":
                s = seqs[k]
            else:
                s = rc.setdefault(k, COMP[seqs[k]][::-1].copy())
            out[sel] = s[start[sel, None] + span]
    return [row.tobytes().decode() for row in out]


def groups(seqs, names, geom: Geometry, device, strands=("+", "-")):
    """{flank: {middle: Counter(genome name -> windows)}} of the surviving
    flanks."""
    g, strand, start = survivors(seqs, geom, device, strands)
    out: dict = {}
    lo, hi = geom.left, geom.left + geom.mid
    for k, w in zip(g.tolist(), _windows(seqs, geom, g, strand, start)):
        mids = out.setdefault(w[:lo] + w[hi:], {})
        mids.setdefault(w[lo:hi], Counter())[names[k]] += 1
    return out


def _labels(counts) -> list[str]:
    return [name for name in sorted(counts) for _ in range(counts[name])]


def _label_text(counts) -> str:
    return ";".join(n if c == 1 else f"{n}({c})"
                    for n, c in sorted(counts.items()))


def _consensus(seqs) -> str:
    out = []
    for col in zip(*seqs):
        letters = set(col)
        out.append("N" if letters & {"N", "*", "?"}
                   else _IUPAC["".join(sorted(letters))])
    return "".join(out)


def _unique_columns(mids: dict, ingroup) -> list[int]:
    if ingroup is None:
        return []
    width = len(next(iter(mids)))
    ins = [set() for _ in range(width)]
    outs = [set() for _ in range(width)]
    for mid, counts in mids.items():
        for name in counts:
            side = ins if name in ingroup else outs
            for i, b in enumerate(mid):
                side[i].add(b)
    return [i for i in range(width) if not ins[i] & outs[i]]


def render(grouped: dict, geom: Geometry, ingroup: set | None,
           filtered: bool) -> tuple[str, str]:
    """(CSV text, alignment text) of the groups, as ``krisp_fasta -s -o``
    writes them."""
    csv = ["left_seq,diag_seq,right_seq"]
    align = []
    for flank in sorted(grouped):
        mids = grouped[flank]
        left, right = flank[:geom.left], flank[geom.left:]
        unique = _unique_columns(mids, ingroup)
        if filtered and not unique:
            continue
        ordered = sorted(mids)
        if len(ordered) == 1:
            members = ordered
        else:
            members = [m for m in ordered
                       if ingroup is None or set(mids[m]) <= ingroup]
        csv.append(",".join([_consensus([left] * len(members)),
                             _consensus(members),
                             _consensus([right] * len(members))]))
        rows = sorted(ordered, key=lambda m: _labels(mids[m]))
        if ingroup is not None:
            rows.sort(key=lambda m: not set(mids[m]) & ingroup)
        lines = [f"{left}{m}{right} : {_label_text(mids[m])}" for m in rows]
        width = geom.mid
        diag = {i for i in range(width) if len({m[i] for m in ordered}) > 1}
        glyph = {-1: "{", width: "}"}
        glyph.update((i, "*") for i in diag)
        glyph.update((i, "#") for i in unique)
        lines.append(" " * (geom.left - 1) + "".join(
            glyph.get(c, "-") for c in range(-1, width + 1)))
        align.append("\n".join(lines) + "\n\n")
    return "\n".join(csv) + "\n", "".join(align)


def search(ingroup_paths, outgroup_paths, geom: Geometry, device="cpu",
           strands=("+", "-")):
    """The CSV and alignment texts of ``krisp_fasta <ingroup> --outgroup
    <outgroup> -s - -o -`` with this geometry, and the survivor count:
    (csv, alignment, {"groups": n, "rows": n})."""
    paths = list(ingroup_paths) + list(outgroup_paths)
    seqs = [read_fasta(p) for p in paths]
    names = [genome_name(p) for p in paths]
    grouped = groups(seqs, names, geom, device, strands)
    ingroup = ({genome_name(p) for p in ingroup_paths}
               if outgroup_paths else None)
    filtered = geom.mid > 0 and bool(outgroup_paths)
    csv, align = render(grouped, geom, ingroup, filtered)
    rows = sum(len(c) for mids in grouped.values() for c in mids.values())
    return csv, align, {"groups": len(grouped), "rows": rows}
