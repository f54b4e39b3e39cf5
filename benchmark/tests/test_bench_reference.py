"""The plain reference equals a brute-force enumeration of strings on
small inputs: the windows of both strands, the survivors, the groups'
counts and the diagnostic filter."""

from collections import Counter

import pytest

from benchmark import genomes
from benchmark.reference import fasta_search as fs
from benchmark.tests import tiny

VALID = set("ABCDGHKMRSTVWY")
COMP = str.maketrans("ACGTRYSWKMBVDHN", "TGCAYRSWMKVBHDN")


def _records(path):
    out, cur = [], None
    for line in open(path):
        line = line.strip()
        if line.startswith(">"):
            cur = []
            out.append(cur)
        else:
            cur.append(line.upper())
    return ["".join(r) for r in out]


def brute(ingroup, outgroup, left, mid, right):
    """({flank: {mid: {name: count}}}, flanks kept by the filter)."""
    L = left + mid + right
    paths = list(ingroup) + list(outgroup)
    counts = Counter()
    for path in paths:
        name = fs.genome_name(path)
        for rec in _records(path):
            rc = "".join(c if c in VALID | {"N"} else "?"
                         for c in rec).translate(COMP)[::-1]
            for s in (rec, rc):
                for i in range(len(s) - L + 1):
                    w = s[i:i + L]
                    if set(w) <= VALID:
                        counts[w[:left] + w[left + mid:], w[left:left + mid],
                               name] += 1
    names = {fs.genome_name(p) for p in paths}
    held = {}
    for (flank, _, name) in counts:
        held.setdefault(flank, set()).add(name)
    groups = {}
    for (flank, m, name), c in counts.items():
        if held[flank] == names:
            groups.setdefault(flank, {}).setdefault(m, {})[name] = c
    ingroup_names = {fs.genome_name(p) for p in ingroup}
    kept = []
    for flank, mids in groups.items():
        for i in range(mid):
            ins = {m[i] for m, c in mids.items() for n in c
                   if n in ingroup_names}
            outs = {m[i] for m, c in mids.items() for n in c
                    if n not in ingroup_names}
            if not ins & outs:
                kept.append(flank)
                break
    return groups, sorted(kept)


CASES = [("spacer-5x40Mb", "distant", {}, 12_000),
         ("spacer-5x40Mb", "related", {"substitution_rate": 0.01}, 12_000),
         ("spacer-5x40Mb", "iupac", {"iupac_every": 97}, 12_000),
         ("amplicon-5x40Mb", "distant", {}, 12_000),
         ("amplicon-5x40Mb", "related", {"substitution_rate": 0.002},
          12_000)]


@pytest.mark.parametrize("config,mix,override,bases", CASES)
def test_reference_equals_brute_force(tmp_path, config, mix, override, bases):
    cfg = tiny.config(config, bases)
    tr = {**tiny.traffic(mix), **override,
          "n_gaps": {"per_mb": 500, "length": 7},
          "softmask": {"per_mb": 500, "length": 30}}
    g = genomes.make_genomes(cfg, tr, 11, tmp_path)
    w = cfg["window"]
    geom = fs.Geometry(w["left"], w["mid"], w["right"])
    want_groups, want_kept = brute(g.ingroup, g.outgroup, w["left"],
                                   w["mid"], w["right"])
    seqs = [fs.read_fasta(p) for p in g.paths]
    got = fs.groups(seqs, [fs.genome_name(p) for p in g.paths], geom, "cpu")
    got = {f: {m: dict(c) for m, c in mids.items()}
           for f, mids in got.items()}
    assert got == want_groups
    assert want_kept   # the planted diagnostic regions
    csv, align, facts = fs.search(g.ingroup, g.outgroup, geom, "cpu")
    rows = csv.splitlines()[1:]
    kept = sorted(r.split(",")[0] + r.split(",")[2] for r in rows)
    assert kept == want_kept
    assert align.count("\n\n") == len(rows)
    assert facts["groups"] == len(want_groups)


def test_forward_strand_only_loses_groups(tmp_path):
    """The control: the same search with the reverse strand left out."""
    cfg = tiny.config("amplicon-5x40Mb", 12_000)
    g = genomes.make_genomes(cfg, tiny.traffic("distant"), 5, tmp_path)
    geom = fs.Geometry(30, 40, 30)
    both = fs.search(g.ingroup, g.outgroup, geom, "cpu")
    fwd = fs.search(g.ingroup, g.outgroup, geom, "cpu", strands=("+",))
    assert fwd[2]["groups"] < both[2]["groups"]
    assert fwd[0] != both[0]


def test_render_matches_upstream_layout():
    """One group by hand: CSV consensus of the ingroup, the alignment's
    row order, labels and bracket."""
    geom = fs.Geometry(3, 2, 2)
    grouped = {"AAACC": {"GT": Counter({"g0": 2, "g1": 1}),
                         "TT": Counter({"g2": 1})}}
    csv, align = fs.render(grouped, geom, {"g0", "g1"}, filtered=True)
    assert csv == "left_seq,diag_seq,right_seq\nAAA,GT,CC\n"
    assert align == ("AAAGTCC : g0(2);g1\n"
                     "AAATTCC : g2\n"
                     "  {#-}\n\n")
