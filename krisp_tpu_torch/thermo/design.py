"""Primer pair design: enumerate, filter, score — primer3-compatible output.

Replaces ``primer3.bindings.design_primers`` as used by the reference
(reference src/krisp/krisp_fasta/Amplicon.py:103-151 and
krisp_vcf.py:528-576): the 'generic' task picking one left + right primer
flanking a SEQUENCE_TARGET, under the same constraint set the reference
exposes on its CLIs (tm / gc / amp_size / primer_size / max_sec_tm /
gc_clamp / max_end_gc, plus primer3 defaults MAX_POLY_X=4 and
MAX_NS_ACCEPTED=0 with LIBERAL_BASE).

Penalty model = primer3 defaults (weights 1.0 on Tm and size deviation from
the optimum, pair penalty = sum of primer penalties) — verified against the
reference README's published primer3 stats (README.md:216-223: penalty
7.74706 = |64.24706-60.5| + |26-30|).

Candidate filters are evaluated vectorized over every (position, length)
with numpy; thermodynamic secondary-structure screens (the expensive DP)
only run on the shortlist, mirroring primer3's own staging.
"""

from __future__ import annotations

import numpy as np

from . import nn

MAX_POLY_X = 4


def _revcomp(seq: str) -> str:
    return "".join(nn.COMP.get(b, "N") for b in reversed(seq.upper()))


def enumerate_candidates(template: str, lo: int, hi: int, primer_size,
                         tm_range, gc_range, gc_clamp, max_end_gc,
                         opt_size, opt_tm, reverse: bool, limit=None):
    """All primers within template[lo:hi] passing the cheap filters —
    vectorized over every (position, length) with numpy; NN ΔH/ΔS window
    sums come from shared accumulators advanced one dimer per size step
    (each candidate's additions happen in its own 5'->3' order, so floats
    match the scalar oracle bit-for-bit; tests/test_thermo.py pins this).

    Returns a list of (penalty, start, length, seq, tm, gc) sorted by
    penalty.  ``reverse``: candidate is the reverse-complement strand (3'
    end at its left edge on the plus strand).
    """
    import math

    region = template[lo:hi].upper()
    n = len(region)
    if n < max(primer_size[0], 2):
        return []
    codes = nn._codes(region)
    raw = np.frombuffer(region.encode(), np.uint8)
    acgt_bad = np.concatenate([[0], np.cumsum(codes >= 4)])
    is_gc = (codes == 1) | (codes == 2)
    gc_pre = np.concatenate([[0], np.cumsum(is_gc)])
    # equal-char run length ending at each position (for MAX_POLY_X)
    pos_i = np.arange(n)
    new_run = np.ones(n, bool)
    new_run[1:] = raw[1:] != raw[:-1]
    run_start = np.maximum.accumulate(np.where(new_run, pos_i, -1))
    runlen = pos_i - run_start + 1
    # a window [s, s+size) contains an equal run longer than MAX_POLY_X
    # (clipped at the window start) iff some p in [s+MAX_POLY_X, s+size)
    # has runlen[p] > MAX_POLY_X: the clipped run ending at p has length
    # min(runlen[p], p-s+1), and p >= s+MAX_POLY_X makes the clip >= the
    # threshold — an O(1)-per-window prefix-sum test
    over_poly = np.concatenate([[0], np.cumsum(runlen > MAX_POLY_X)])

    # NN dimer tables for the plus strand and (for reverse candidates) the
    # reverse-complement strand, with a 0 sentinel so reduceat boundaries
    # may reach n-1
    dimv = codes[:-1].astype(np.int32) * 5 + codes[1:]
    dh_plus = np.concatenate([nn._DH_LUT[dimv], [0.0]])
    ds_plus = np.concatenate([nn._DS_LUT[dimv], [0.0]])
    if reverse:
        codes_rc = np.where(codes[::-1] < 4, 3 - codes[::-1], 4)
        dimv_rc = codes_rc[:-1].astype(np.int32) * 5 + codes_rc[1:]
        dh_rc = np.concatenate([nn._DH_LUT[dimv_rc], [0.0]])
        ds_rc = np.concatenate([nn._DS_LUT[dimv_rc], [0.0]])

    salt = nn.effective_monovalent() / 1000.0
    log_salt = math.log(salt)
    log_c4 = math.log(50.0 * 1e-9 / 4.0)

    out = []
    rc_region = _revcomp(region) if reverse else None

    # Shared ΔH/ΔS accumulators over ALL start positions, advanced one
    # dimer per size step: after K steps acc[j] = dh[j] + dh[j+1] + ... +
    # dh[j+K-1] added in exactly the candidate's 5'->3' dimer order, so a
    # size-s window's sum is a single gather acc[ks] after s-1 steps —
    # bit-identical to the per-size loop it replaces (pinned vs the scalar
    # oracle in tests/test_thermo.py) at ~1/sizes the vector-op count.
    acc_dh = np.zeros(n)
    acc_ds = np.zeros(n)
    src_dh, src_ds = (dh_rc, ds_rc) if reverse else (dh_plus, ds_plus)
    acc_steps = 0

    def _advance(to_steps):
        nonlocal acc_steps
        while acc_steps < to_steps:
            k = acc_steps
            acc_dh[:n - k] += src_dh[k:n]
            acc_ds[:n - k] += src_ds[k:n]
            acc_steps += 1

    # all cheap filters for every (size, start) in one 2-D pass: purely
    # boolean/int prefix-sum tests, so vectorizing across sizes cannot
    # perturb any float (the NN sums below keep their per-size order)
    s_lo, s_hi = primer_size[0], min(primer_size[1], n)
    sizes = np.arange(s_lo, s_hi + 1)
    starts2 = np.arange(n - s_lo + 1)
    ends2 = sizes[:, None] + starts2[None, :]        # (S, n_starts)
    in_range = ends2 <= n
    e2 = np.minimum(ends2, n)
    keep2 = in_range & ((acgt_bad[e2] - acgt_bad[starts2][None, :]) == 0)
    poly_rows = sizes > MAX_POLY_X
    if poly_rows.any():
        pstart = np.minimum(starts2 + MAX_POLY_X, n)
        keep2 &= np.where(poly_rows[:, None],
                          (over_poly[e2] - over_poly[pstart][None, :]) == 0,
                          True)
    gc_cnt2 = gc_pre[e2] - gc_pre[starts2][None, :]
    gc_val2 = 100.0 * gc_cnt2 / sizes[:, None]
    keep2 &= (gc_val2 >= gc_range[0]) & (gc_val2 <= gc_range[1])
    if gc_clamp:
        # primer 3' end: window tail (forward) / head (reverse);
        # complementation preserves G/C membership
        if reverse:
            clamp2 = (gc_pre[np.minimum(starts2 + gc_clamp, n)]
                      - gc_pre[starts2])[None, :]
        else:
            clamp2 = gc_pre[e2] - gc_pre[np.maximum(e2 - gc_clamp, 0)]
        keep2 &= clamp2 == gc_clamp
    if max_end_gc is not None:
        k5s = np.minimum(5, sizes)
        if reverse:
            end2 = (gc_pre[np.minimum(starts2[None, :] + k5s[:, None], n)]
                    - gc_pre[starts2][None, :])
        else:
            end2 = gc_pre[e2] - gc_pre[np.maximum(e2 - k5s[:, None], 0)]
        keep2 &= end2 <= max_end_gc

    for si, size in enumerate(sizes):
        keep = keep2[si, :n - size + 1]
        if not keep.any():
            continue
        gc_val = gc_val2[si, :n - size + 1]
        ks = np.nonzero(keep)[0]
        _advance(size - 1)
        if reverse:
            b0 = n - ks - size
            dh = acc_dh[b0]
            ds = acc_ds[b0]
            first_gc = is_gc[ks + size - 1]   # seq[0] = comp(plus last)
            last_gc = is_gc[ks]               # seq[-1] = comp(plus first)
        else:
            dh = acc_dh[ks]
            ds = acc_ds[ks]
            first_gc = is_gc[ks]
            last_gc = is_gc[ks + size - 1]
        dh = dh + np.where(first_gc, nn.INIT_GC_DH, nn.INIT_AT_DH)
        ds = ds + np.where(first_gc, nn.INIT_GC_DS, nn.INIT_AT_DS)
        dh = dh + np.where(last_gc, nn.INIT_GC_DH, nn.INIT_AT_DH)
        ds = ds + np.where(last_gc, nn.INIT_GC_DS, nn.INIT_AT_DS)
        ds_corr = ds + 0.368 * (size - 1) * log_salt
        tm_val = (dh * 1000.0) / (ds_corr + nn.R_GAS * log_c4) - 273.15
        tok = (tm_val >= tm_range[0]) & (tm_val <= tm_range[1])
        pen = np.abs(tm_val - opt_tm) + abs(size - opt_size)
        gcv = gc_val[keep]
        sel = np.nonzero(tok)[0]
        if sel.size:
            out.append((pen[sel], ks[sel], size, tm_val[sel], gcv[sel]))

    if not out:
        return []
    pen_a = np.concatenate([c[0] for c in out])
    s_a = np.concatenate([c[1] for c in out])
    size_a = np.concatenate([np.full(c[0].shape[0], c[2]) for c in out])
    tm_a = np.concatenate([c[3] for c in out])
    gc_a = np.concatenate([c[4] for c in out])
    # total order (penalty, start, size) — identical to sorting the tuple
    # list (the 3-key is unique per candidate: start+size identify it)
    order = np.lexsort((size_a, s_a, pen_a))
    if limit is not None:
        order = order[:limit]
    result = []
    for idx in order:
        s = int(s_a[idx])
        size = int(size_a[idx])
        seq = (rc_region[n - s - size:n - s] if reverse
               else region[s:s + size])
        result.append((float(pen_a[idx]), lo + s, size, seq,
                       float(tm_a[idx]), float(gc_a[idx])))
    return result


def enumerate_candidates_scalar(template: str, lo: int, hi: int, primer_size,
                                tm_range, gc_range, gc_clamp, max_end_gc,
                                opt_size, opt_tm, reverse: bool):
    """Reference implementation (per-candidate Python loops); the equality
    oracle for the vectorized ``enumerate_candidates``."""
    out = []
    region = template[lo:hi].upper()
    n = len(region)
    is_acgt = np.frombuffer(region.encode(), np.uint8)
    acgt_ok = np.isin(is_acgt, np.frombuffer(b"ACGT", np.uint8))
    bad_prefix = np.concatenate([[0], np.cumsum(~acgt_ok)])
    for size in range(primer_size[0], primer_size[1] + 1):
        for start in range(0, n - size + 1):
            if bad_prefix[start + size] - bad_prefix[start] > 0:
                continue  # MAX_NS_ACCEPTED=0 after liberal-base conversion
            plus = region[start:start + size]
            seq = _revcomp(plus) if reverse else plus
            if _max_poly_x(seq) > MAX_POLY_X:
                continue
            gc = nn.gc_percent(seq)
            if not (gc_range[0] <= gc <= gc_range[1]):
                continue
            if gc_clamp and any(b not in "GC" for b in seq[-gc_clamp:]):
                continue
            if max_end_gc is not None:
                if sum(1 for b in seq[-5:] if b in "GC") > max_end_gc:
                    continue
            tm = nn.tm_santalucia(seq)
            if not (tm_range[0] <= tm <= tm_range[1]):
                continue
            penalty = abs(tm - opt_tm) + abs(size - opt_size)
            out.append((penalty, lo + start, size, seq, tm, gc))
    out.sort(key=lambda c: (c[0], c[1], c[2]))
    return out


def _max_poly_x(seq: str) -> int:
    best = run = 1
    for a, b in zip(seq, seq[1:]):
        run = run + 1 if a == b else 1
        best = max(best, run)
    return best


class _DesignJob:
    """One design_primers instance as an incremental state machine, so a
    batch caller can fuse the structure-screen rounds of MANY templates
    into single numpy passes (``batch_self_screens`` results are invariant
    to batch composition — pinned by tests/test_thermo.py).

    Protocol: drive the ``run()`` generator — it yields
    ``("self", [seqs])`` and ``("pair", (s1, s2))`` screen requests and
    receives the results via ``send()``; when it returns, ``output()``
    yields the primer3-shaped dict.  The round structure, early-stop
    bound, and pair iteration order are identical to the serial loop this
    replaces (the generator preserves the exact control flow across
    suspensions), so results are bit-equal."""

    CHUNK = 8

    def __init__(self, template, target_start, target_len, tm=(53, 68),
                 gc=(40, 70), amp_size=(80, 300), primer_size=(25, 35),
                 max_sec_tm=40, gc_clamp=1, max_end_gc=4,
                 max_candidates=64, _exhaustive=False):
        template = "".join(template)
        self.template = template
        self.amp_size = amp_size
        self.max_sec_tm = max_sec_tm
        self._exhaustive = _exhaustive
        n = len(template)
        opt_size = (primer_size[0] + primer_size[1]) / 2
        opt_tm = (tm[0] + tm[1]) / 2
        target_end = target_start + target_len  # exclusive

        # only the top ``max_candidates`` by penalty are ever screened; the
        # limit skips tuple/sequence materialization for the rejected tail
        self.short_l = enumerate_candidates(
            template, 0, target_start, primer_size, tm, gc, gc_clamp,
            max_end_gc, opt_size, opt_tm, reverse=False,
            limit=max_candidates)
        self.short_r = enumerate_candidates(
            template, target_end, n, primer_size, tm, gc, gc_clamp,
            max_end_gc, opt_size, opt_tm, reverse=True,
            limit=max_candidates)

        # Staged structure screening in penalty order with a sound lower-
        # bound early stop: a pair involving an unscreened candidate can
        # never beat ``short_l[l_done].pen + short_r[0].pen`` (and
        # symmetrically), so once the best found pair is at or below that
        # bound the remaining screens cannot change the selection —
        # identical output to screening all ``max_candidates``, usually
        # after one small chunk.
        self.l_done = self.r_done = 0
        self.lefts_ok: list = []
        self.rights_ok: list = []
        self.compl_memo: dict = {}
        self.best = None

    def run(self):
        """Generator: yields screen requests, receives results, returns
        when the selection is final (identical control flow to the serial
        loop — suspension points only replace direct nn calls)."""
        while True:
            lchunk = self.short_l[self.l_done:self.l_done + self.CHUNK]
            rchunk = self.short_r[self.r_done:self.r_done + self.CHUNK]
            # one fused screen batch per round: left and right chunks
            # share a single pass (results are per-sequence, so batching
            # is output-invariant — pinned by tests/test_thermo.py)
            ths = yield ("self", [c[3] for c in lchunk]
                         + [c[3] for c in rchunk])
            for c, th in zip(lchunk, ths[:len(lchunk)]):
                if max(th) <= self.max_sec_tm:
                    self.lefts_ok.append((c, th))
            for c, th in zip(rchunk, ths[len(lchunk):]):
                if max(th) <= self.max_sec_tm:
                    self.rights_ok.append((c, th))
            self.l_done += len(lchunk)
            self.r_done += len(rchunk)
            progressed = bool(lchunk) or bool(rchunk)

            amp_size, max_sec_tm = self.amp_size, self.max_sec_tm
            best = self.best
            for lc, lth in self.lefts_ok:
                for rc, rth in self.rights_ok:
                    l_pen, l_start, l_size = lc[0], lc[1], lc[2]
                    r_pen, r_start, r_size = rc[0], rc[1], rc[2]
                    product = (r_start + r_size) - l_start
                    if not (amp_size[0] <= product <= amp_size[1]):
                        continue
                    pair_pen = l_pen + r_pen
                    if best is not None and pair_pen >= best["penalty"]:
                        continue
                    key = (l_start, l_size, r_start, r_size)
                    th2 = self.compl_memo.get(key)
                    if th2 is None:
                        # one pass computes both ANY and END
                        th2 = yield ("pair", (lc[3], rc[3]))
                        self.compl_memo[key] = th2
                    compl_any, compl_end = th2
                    if compl_any > max_sec_tm or compl_end > max_sec_tm:
                        continue
                    best = {"penalty": pair_pen, "left": (lc, lth),
                            "right": (rc, rth), "product": product,
                            "compl_any": compl_any, "compl_end": compl_end}
            self.best = best

            lb = None
            if self.l_done < len(self.short_l) and self.short_r:
                lb = self.short_l[self.l_done][0] + self.short_r[0][0]
            if self.r_done < len(self.short_r) and self.short_l:
                lb2 = self.short_l[0][0] + self.short_r[self.r_done][0]
                lb = lb2 if lb is None else min(lb, lb2)
            if (not self._exhaustive and best is not None
                    and (lb is None or best["penalty"] < lb)):
                # strict: an unscreened pair tying on penalty could
                # precede in the full iteration order, so ties keep
                # screening
                return
            if not progressed:
                return

    def output(self):
        out = {}
        best = self.best
        if best is None:
            out["PRIMER_PAIR_NUM_RETURNED"] = 0
            out["PRIMER_LEFT_NUM_RETURNED"] = 0
            out["PRIMER_RIGHT_NUM_RETURNED"] = 0
            return out

        (l_pen, l_start, l_size, l_seq, l_tm, l_gc), (l_sa, l_se, l_hp) = \
            best["left"]
        (r_pen, r_start, r_size, r_seq, r_tm, r_gc), (r_sa, r_se, r_hp) = \
            best["right"]
        big_neg = -1.7976931348623157e+308  # primer3's "not computed"

        def oligo(prefix, pen, seq, tm_v, gc_v, sa, se, hp):
            out[f"{prefix}_PENALTY"] = round(pen, 5)
            out[f"{prefix}_SEQUENCE"] = seq
            out[f"{prefix}_TM"] = round(tm_v, 5)
            out[f"{prefix}_GC_PERCENT"] = round(gc_v, 5)
            out[f"{prefix}_SELF_ANY_TH"] = sa
            out[f"{prefix}_SELF_END_TH"] = se
            out[f"{prefix}_HAIRPIN_TH"] = hp
            out[f"{prefix}_POSITION_PENALTY"] = 0.0
            out[f"{prefix}_END_STABILITY"] = nn.end_stability(seq)
            out[f"{prefix}_TEMPLATE_MISPRIMING"] = big_neg
            out[f"{prefix}_TEMPLATE_MISPRIMING_TH"] = big_neg

        out["PRIMER_PAIR_NUM_RETURNED"] = 1
        out["PRIMER_LEFT_NUM_RETURNED"] = 1
        out["PRIMER_RIGHT_NUM_RETURNED"] = 1
        out["PRIMER_LEFT_0"] = [l_start, l_size]
        # primer3 convention: right primer position = its 3'-most plus-
        # strand index (the reference decodes it as such,
        # krisp_vcf.py:660-666)
        out["PRIMER_RIGHT_0"] = [r_start + r_size - 1, r_size]
        oligo("PRIMER_LEFT_0", l_pen, l_seq, l_tm, l_gc, l_sa, l_se, l_hp)
        oligo("PRIMER_RIGHT_0", r_pen, r_seq, r_tm, r_gc, r_sa, r_se, r_hp)
        out["PRIMER_PAIR_0_PENALTY"] = round(best["penalty"], 5)
        out["PRIMER_PAIR_0_COMPL_ANY_TH"] = best["compl_any"]
        out["PRIMER_PAIR_0_COMPL_END_TH"] = best["compl_end"]
        out["PRIMER_PAIR_0_PRODUCT_SIZE"] = best["product"]
        product_seq = self.template[l_start:r_start + r_size]
        # primer3 computes product Tm with the long-sequence GC-fraction
        # formula (oligotm long_seq_tm), NOT nearest-neighbor — exact on
        # the README's published 84.32116 (ambiguous consensus bases are
        # simply not counted as G/C, where NN math would have no Tm)
        prod_tm = nn.tm_long_seq(product_seq)
        out["PRIMER_PAIR_0_PRODUCT_TM"] = round(prod_tm, 5)
        out["PRIMER_PAIR_0_PRODUCT_TM_OLIGO_TM_DIFF"] = round(
            prod_tm - min(l_tm, r_tm), 5)
        out["PRIMER_PAIR_0_T_OPT_A"] = round(
            0.3 * min(l_tm, r_tm) + 0.7 * prod_tm - 14.9, 5)
        out["PRIMER_PAIR_0_TEMPLATE_MISPRIMING"] = big_neg
        return out


# Structure screens are pure functions of the oligo sequence (the salt
# model is fixed constants, nn.effective_monovalent), and sliding windows
# re-screen the SAME candidate primers across overlapping templates — a
# sequence-keyed memo removes the repeats bit-exactly
# (nn.batch_self_screens / pair_screens_batch are composition-invariant,
# pinned by tests/test_thermo.py).
_SELF_MEMO_CAP = 1 << 19
_SELF_MEMO: dict = {}
_PAIR_MEMO: dict = {}


def _memo_batch(memo, keys, compute):
    """Memoized batched evaluation preserving input order."""
    miss = [k for k in dict.fromkeys(keys) if k not in memo]
    if miss:
        if len(memo) + len(miss) > _SELF_MEMO_CAP:
            memo.clear()
        for k, r in zip(miss, compute(miss)):
            memo[k] = r
    return [memo[k] for k in keys]


def clear_screen_memos():
    """Drop the screen memos (bench methodology: a 'warm' scan means warm
    code paths, not pre-computed screen answers)."""
    _SELF_MEMO.clear()
    _PAIR_MEMO.clear()


def design_primers_batch(jobs_args, **kwargs):
    """Design primer pairs for many (template, target_start, target_len)
    jobs, fusing each screen round across every live job: one
    ``batch_self_screens`` pass for all candidate-chunk requests and one
    ``pair_screens_batch`` pass for all pair requests per batch round.
    Per-job results are bit-identical to ``design_primers`` run serially
    (rounds, early stops, and pair orders are per-job generator state;
    only the numpy batching is shared — both batchings are composition-
    invariant, pinned by tests/test_thermo.py)."""
    jobs = [_DesignJob(*a, **kwargs) for a in jobs_args]
    live = []
    for j in jobs:
        g = j.run()
        try:
            live.append((g, g.send(None)))
        except StopIteration:
            pass
    while live:
        results = [None] * len(live)
        selfs = [(i, r[1]) for i, (_, r) in enumerate(live)
                 if r[0] == "self"]
        if selfs:
            ths = _memo_batch(_SELF_MEMO,
                              [s for _, seqs in selfs for s in seqs],
                              nn.batch_self_screens)
            off = 0
            for i, seqs in selfs:
                results[i] = ths[off:off + len(seqs)]
                off += len(seqs)
        prs = [(i, r[1]) for i, (_, r) in enumerate(live)
               if r[0] == "pair"]
        if prs:
            for (i, _), th2 in zip(prs,
                                   _memo_batch(_PAIR_MEMO,
                                               [tuple(p) for _, p in prs],
                                               nn.pair_screens_batch)):
                results[i] = th2
        nxt = []
        for (g, _), res in zip(live, results):
            try:
                nxt.append((g, g.send(res)))
            except StopIteration:
                pass
        live = nxt
    return [j.output() for j in jobs]


def design_primers(template, target_start, target_len, **kwargs):
    """Pick the best primer pair flanking the target; primer3-shaped dict."""
    return design_primers_batch([(template, target_start, target_len)],
                                **kwargs)[0]


def run_primer3(template, target_start, target_len, options=None, tm=(53, 68),
                gc=(40, 70), amp_size=(80, 300), primer_size=(25, 35),
                max_sec_tm=40, gc_clamp=1, max_end_gc=4):
    """Drop-in for the reference's run_primer3 wrapper (Amplicon.py:103-151).

    Prefers the real primer3-py bindings when importable (bit-parity with
    libprimer3); otherwise uses the self-contained engine above.
    ``options`` (a BoulderIO settings file) is honored via
    parse_primer3_settings when the real bindings are present.
    """
    try:
        import primer3 as _p3  # the C library, if the env provides it
        from statistics import mean
        global_options = {
            'PRIMER_TASK': 'generic',
            'PRIMER_PICK_LEFT_PRIMER': 1,
            'PRIMER_PICK_RIGHT_PRIMER': 1,
            'PRIMER_LIBERAL_BASE': 1,
            'PRIMER_OPT_SIZE': mean(primer_size),
            'PRIMER_MIN_SIZE': primer_size[0],
            'PRIMER_MAX_SIZE': primer_size[1],
            'PRIMER_OPT_TM': mean(tm),
            'PRIMER_MIN_TM': tm[0], 'PRIMER_MAX_TM': tm[1],
            'PRIMER_MIN_GC': gc[0], 'PRIMER_MAX_GC': gc[1],
            'PRIMER_MAX_POLY_X': 4,
            'PRIMER_MAX_NS_ACCEPTED': 0,
            'PRIMER_THERMODYNAMIC_OLIGO_ALIGNMENT': 1,
            'PRIMER_MAX_SELF_ANY_TH': max_sec_tm,
            'PRIMER_MAX_SELF_END_TH': max_sec_tm,
            'PRIMER_PAIR_MAX_COMPL_ANY_TH': max_sec_tm,
            'PRIMER_PAIR_MAX_COMPL_END_TH': max_sec_tm,
            'PRIMER_MAX_HAIRPIN_TH': max_sec_tm,
            'PRIMER_PRODUCT_SIZE_RANGE': [list(amp_size)],
            'PRIMER_GC_CLAMP': gc_clamp,
            'PRIMER_MAX_END_GC': max_end_gc,
        }
        return _p3.bindings.design_primers(
            {'SEQUENCE_TEMPLATE': "".join(template),
             'SEQUENCE_TARGET': [target_start, target_len]},
            global_options)
    except ImportError:
        kwargs = dict(tm=tm, gc=gc, amp_size=amp_size,
                      primer_size=primer_size, max_sec_tm=max_sec_tm,
                      gc_clamp=gc_clamp, max_end_gc=max_end_gc)
        if options is not None:
            kwargs.update(engine_params_from_settings(
                parse_primer3_settings(options)))
        return design_primers("".join(template), target_start, target_len,
                              **kwargs)


def run_primer3_batch(jobs, options=None, **kwargs):
    """Batched ``run_primer3`` over (template, target_start, target_len)
    jobs: the self-contained engine fuses each structure-screen round
    across every job into one numpy pass.  When the real primer3-py
    bindings are importable they are preferred (bit parity with
    libprimer3), falling back to one serial call per job."""
    try:
        import primer3  # noqa: F401  (the C library, if the env has it)
        return [run_primer3(t, s, ln, options=options, **kwargs)
                for (t, s, ln) in jobs]
    except ImportError:
        kw = dict(kwargs)
        if options is not None:
            kw.update(engine_params_from_settings(
                parse_primer3_settings(options)))
        return design_primers_batch(
            [("".join(t), s, ln) for (t, s, ln) in jobs], **kw)


def design_primers_for_group(group, **p3_args):
    """krisp_fasta hook: score a FlankGroup's ingroup consensus template
    (parity: Amplicon.py:560-564).  Returns True iff a pair was found."""
    consensus = group.ingroup_consensus()
    template = "".join(consensus.values())
    group.p3 = run_primer3(template,
                           target_start=len(consensus["forward"]),
                           target_len=len(consensus["diagnostic"]),
                           **p3_args)
    return group.p3["PRIMER_PAIR_NUM_RETURNED"] != 0


def parse_primer3_settings(file_path):
    """BoulderIO global-settings parser (parity: Amplicon.py:69-97 /
    krisp_vcf.py:497-525): number coercion, space/semicolon lists, and
    comma/dash ranges."""
    import re

    def to_number_if_can(x):
        try:
            if int(float(x)) == float(x) and "." not in x:
                return int(x)
            return float(x)
        except ValueError:
            return x

    with open(file_path) as handle:
        options = dict(tuple(l.strip().split("="))
                       for l in handle.readlines())
    for opt, val in options.items():
        if " " in val or ";" in val:
            val = re.split("[ ;]+", val)
            val = [to_number_if_can(v) for v in val]
            if "," in val or "-" in val[0]:
                val = [[to_number_if_can(x) for x in re.split("[,\\-]+", v)]
                       for v in val]
        elif "," in val or "-" in val:
            val = re.split("[,\\-]+", val)
            val = [to_number_if_can(v) for v in val]
        else:
            val = to_number_if_can(val)
        options[opt] = val
    return options


def engine_params_from_settings(options):
    """Map a parsed BoulderIO settings dict onto the native engine's
    parameters (used when the real primer3-py is unavailable)."""
    params = {}
    if "PRIMER_MIN_TM" in options and "PRIMER_MAX_TM" in options:
        params["tm"] = (options["PRIMER_MIN_TM"], options["PRIMER_MAX_TM"])
    if "PRIMER_MIN_GC" in options and "PRIMER_MAX_GC" in options:
        params["gc"] = (options["PRIMER_MIN_GC"], options["PRIMER_MAX_GC"])
    if "PRIMER_MIN_SIZE" in options and "PRIMER_MAX_SIZE" in options:
        params["primer_size"] = (options["PRIMER_MIN_SIZE"],
                                 options["PRIMER_MAX_SIZE"])
    if "PRIMER_PRODUCT_SIZE_RANGE" in options:
        rng = options["PRIMER_PRODUCT_SIZE_RANGE"]
        if isinstance(rng, list) and rng and isinstance(rng[0], list):
            rng = rng[0]
        params["amp_size"] = tuple(rng[:2])
    if "PRIMER_MAX_SELF_ANY_TH" in options:
        params["max_sec_tm"] = options["PRIMER_MAX_SELF_ANY_TH"]
    if "PRIMER_GC_CLAMP" in options:
        params["gc_clamp"] = options["PRIMER_GC_CLAMP"]
    if "PRIMER_MAX_END_GC" in options:
        params["max_end_gc"] = options["PRIMER_MAX_END_GC"]
    return params
