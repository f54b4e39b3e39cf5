"""Exhaustive structure-search oracle for the thal-replacement screens.

The production screens (nn.py `batch_self_screens` / `pair_screens_batch`)
search structures of one, two, or three helices drawn from the top-16
(top-6 for three-helix) strongest maximal match-runs per candidate.  The
reference's engine — libprimer3's thal, called at
reference src/krisp/krisp_fasta/Amplicon.py:143-151 and
krisp_vcf.py:568-576 — performs a full DP over all defect counts, so the
production truncation is a modeling choice that VERDICT r2 asked to be
*bounded*, not asserted.

This module is that bound: a chain DP over ALL maximal match-runs with an
UNLIMITED number of helices per structure (any defect count) and no
shortlist, under the identical grammar and parameter set:

  - helices are maximal perfectly-complementary stacked runs (len >= 2 in
    chains, len >= 3 stand-alone), scored with the SantaLucia NN tables;
  - consecutive helices are joined by one bulge (one gap side zero) or
    internal loop (both sides > 0), entropic, SantaLucia & Hicks 2004
    tables with Jacobson-Stockmayer extrapolation, clipped at 64 nt;
    1-2 nt internal loops are non-finite in the tables (disallowed) —
    exactly as in nn.py;
  - hairpin structures pay the terminal loop of the innermost helix plus
    the loop-closure terminal-mismatch term, rank by -dG37 and gate at
    37 C; duplex structures rank by the bimolecular Tm.

Ranking objectives are monotone (more-negative dH better, less-negative
dS better), so the DP keeps a Pareto front of (dH, dS) per run and is
exact without enumerating the exponential chain set.

tests/test_thermo_oracle.py fuzzes the production screens against this
oracle; the measured search-truncation gap is recorded in PARITY.md.
"""

from __future__ import annotations

import math

import numpy as np

from .nn import (
    DANGLE5_DS,
    TMM_DS,
    _BULGE_DS,
    _CODE,
    _COMP_CODE,
    _DH_LUT,
    _DS_LUT,
    _HAIRPIN_DS,
    _INTERNAL_DS,
    _MAX_LOOP,
    _neg_dg37,
    _tm_of,
    duplex_tm,
    hairpin_gate_tm,
)


def _codes(s: str) -> np.ndarray:
    return _CODE[np.frombuffer(s.upper().encode(), np.uint8)]


class _Run:
    __slots__ = ("i0", "i1", "k0", "k1", "dh", "ds", "length")

    def __init__(self, i0, i1, k0, k1, dh, ds, length):
        self.i0, self.i1, self.k0, self.k1 = i0, i1, k0, k1
        self.dh, self.ds, self.length = dh, ds, length


def _duplex_runs(a: np.ndarray, brev: np.ndarray):
    """All maximal complementary runs of s1 (codes ``a``) against the
    reversed s2 (codes ``brev``): duplex diagonals, k = column index."""
    n, m = a.size, brev.size
    comp = _COMP_CODE[a]
    runs = []
    for d in range(-(m - 1), n):
        i = max(0, d)
        hi = min(n, m + d)
        while i < hi:
            if comp[i] == brev[i - d]:
                i0 = i
                dh = ds = 0.0
                i += 1
                while i < hi and comp[i] == brev[i - d]:
                    idx = int(a[i - 1]) * 5 + int(a[i])
                    dh += _DH_LUT[idx]
                    ds += _DS_LUT[idx]
                    i += 1
                runs.append(_Run(i0, i - 1, i0 - d, i - 1 - d,
                                 dh, ds, i - i0))
            else:
                i += 1
    return runs


def _hairpin_runs(codes: np.ndarray):
    """All maximal stem runs of a single sequence against itself:
    anti-diagonal geometry, match requires y - x > 3 at every cell (the
    same mask nn.py builds), run start = outermost pair."""
    n = codes.size
    comp = _COMP_CODE[codes]
    runs = []
    for q in range(2 * n - 1):  # anti-diagonal x + y = q
        x = max(0, q - (n - 1))
        while True:
            y = q - x
            if y - x <= 3:
                break
            if comp[x] == codes[y]:
                x0, y0 = x, y
                dh = ds = 0.0
                x += 1
                while q - x - x > 3 and comp[x] == codes[q - x]:
                    idx = int(codes[x - 1]) * 5 + int(codes[x])
                    dh += _DH_LUT[idx]
                    ds += _DS_LUT[idx]
                    x += 1
                runs.append(_Run(x0, x - 1, y0, q - x + 1, dh, ds, x - x0))
            else:
                x += 1
    return runs


def _join_ds(outer: _Run, inner: _Run, inner_desc: bool):
    """Entropic cost of joining ``outer`` -> ``inner``; None if the
    geometry or the loop tables disallow the join (nn.py's rules)."""
    gap1 = inner.i0 - outer.i1 - 1
    if inner_desc:
        gap2 = outer.k1 - inner.k0 - 1
    else:
        gap2 = inner.k0 - outer.k1 - 1
    if gap1 < 0 or gap2 < 0 or gap1 + gap2 == 0:
        return None
    size = min(gap1 + gap2, _MAX_LOOP)
    ds = _BULGE_DS[size] if (gap1 == 0 or gap2 == 0) else _INTERNAL_DS[size]
    if not math.isfinite(ds):
        return None
    return ds


def _pareto(entries):
    """Prune (dh, ds, eligible) triples: drop any entry dominated by one
    with dh' <= dh, ds' >= ds (strict somewhere) and eligible' >= eligible.
    Both ranking objectives are monotone in (-dh, +ds), and eligibility
    (may the entry stand as a finished structure?) only widens uses."""
    if len(entries) <= 1:
        return entries
    entries.sort(key=lambda e: (e[0], -e[1], not e[2]))
    kept = []
    best_ds_any = -math.inf   # max ds among all kept entries
    best_ds_elig = -math.inf  # max ds among kept ELIGIBLE entries
    for dh, ds, elig in entries:
        # dh of every kept entry is already <= ours (sort order); an
        # eligible entry may only be pruned by an eligible dominator
        if ds <= (best_ds_elig if elig else best_ds_any):
            continue
        kept.append((dh, ds, elig))
        if elig:
            best_ds_elig = max(best_ds_elig, ds)
        best_ds_any = max(best_ds_any, ds)
    return kept


def _chain_entries(runs, inner_desc: bool, dangle5_ds: float = 0.0):
    """Pareto sets of (dh, ds, eligible_as_final) per run, over ALL
    structures (any helix count) whose innermost/3'-most helix is that
    run.  ``eligible_as_final``: chains always; single helices only when
    len >= 3 (nn.py's single-helix class).

    ``dangle5_ds`` (hairpins): 5'-dangling-end stabilization added to the
    OUTERMOST helix when an unpaired base precedes its 5' start (i0 > 0);
    base entries carry it, chain joins add raw run energies on top, so
    every chain inherits exactly its outermost run's term."""
    runs = [r for r in runs if r.length >= 2]
    runs.sort(key=lambda r: r.i0)
    sets: list[list] = []
    for ri, r in enumerate(runs):
        entries = [(r.dh, r.ds + (dangle5_ds if r.i0 > 0 else 0.0),
                    r.length >= 3)]
        for rj in range(ri):
            outer = runs[rj]
            ds_join = _join_ds(outer, r, inner_desc)
            if ds_join is None:
                continue
            for dh_p, ds_p, _elig in sets[rj]:
                entries.append((dh_p + r.dh, ds_p + r.ds + ds_join, True))
        sets.append(_pareto(entries))
    return runs, sets


def _best_duplex(runs, end_i=None):
    """(dh, ds) of the max-Tm duplex structure, (0, 0) when none."""
    runs, sets = _chain_entries(runs, inner_desc=False)
    best_tm = -math.inf
    best = (0.0, 0.0)
    for r, entries in zip(runs, sets):
        if end_i is not None and r.i1 != end_i:
            continue
        for dh, ds, elig in entries:
            if not elig or dh >= 0 or ds >= 0:
                continue
            tm = float(_tm_of(np.float64(dh), np.float64(ds)))
            if tm > best_tm:
                best_tm = tm
                best = (dh, ds)
    return best


def _best_hairpin(runs):
    """(dh, ds incl. terminal loop) of the min-dG37 hairpin structure."""
    runs, sets = _chain_entries(runs, inner_desc=True,
                                dangle5_ds=DANGLE5_DS)
    best_rank = -math.inf
    best = (0.0, 0.0)
    for r, entries in zip(runs, sets):
        tloop = min(max(r.k1 - r.i1 - 1, 3), _MAX_LOOP)
        ds_term = _HAIRPIN_DS[tloop] + (TMM_DS if tloop > 3 else 0.0)
        for dh, ds, elig in entries:
            if not elig or dh >= 0:
                continue
            rank = float(_neg_dg37(dh, ds + ds_term))
            if rank > best_rank:
                best_rank = rank
                best = (dh, ds + ds_term)
    return best


def self_screens_oracle(seq: str):
    """(self_any_th, self_end_th, hairpin_th) under the exhaustive
    any-defect-count structure search; the unrestricted counterpart of
    ``nn.batch_self_screens([seq])[0]``."""
    codes = _codes(seq)
    n = codes.size
    if n < 2:
        return (0.0, 0.0, 0.0)
    druns = _duplex_runs(codes, codes[::-1])
    any_dh, any_ds = _best_duplex(druns)
    end_dh, end_ds = _best_duplex(druns, end_i=n - 1)
    hp_dh, hp_ds = _best_hairpin(_hairpin_runs(codes))
    return (round(duplex_tm(any_dh, any_ds), 5),
            round(duplex_tm(end_dh, end_ds), 5),
            round(hairpin_gate_tm(hp_dh, hp_ds), 5))


def pair_screens_oracle(s1: str, s2: str):
    """(PAIR_COMPL_ANY_TH, PAIR_COMPL_END_TH), exhaustive counterpart of
    ``nn.pair_screens``."""
    a = _codes(s1)
    b = _codes(s2)
    if a.size < 2 or b.size < 2:
        return (0.0, 0.0)
    druns = _duplex_runs(a, b[::-1])
    any_dh, any_ds = _best_duplex(druns)
    end_dh, end_ds = _best_duplex(druns, end_i=a.size - 1)
    return (round(duplex_tm(any_dh, any_ds), 5),
            round(duplex_tm(end_dh, end_ds), 5))
