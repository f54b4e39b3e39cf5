"""The diagnostic-region filter cascade over sliding windows.

Semantics parity with the reference's ``find_diag_region``
(reference src/krisp/krisp_vcf/krisp_vcf.py:680-916), including its
CLI-observable quirks: the hardcoded 30 nt primer-flank requirement
(krisp_vcf.py:849-853) and the rightmost-single-variant rule.
"""

from __future__ import annotations

from .classify import ClassifiedVariant
from .region import VariantWindow, DiagnosticRegion, consv_border_n


def edit_distance(a: str, b: str) -> int:
    """Levenshtein distance (replaces the reference's nltk dependency,
    krisp_vcf.py:19,864; identical metric: unit costs, no transpositions).

    Vectorized row recurrence: after taking the elementwise min of the
    deletion and substitution candidates, the insertion chain
    ``row[j] = min(tmp[j], row[j-1]+1)`` closes in one prefix scan because
    ``row[j] = j + min_{i<=j}(tmp[i]-i)``.  Integer-exact, equal to the
    scalar DP (pinned by tests)."""
    import numpy as np

    if len(a) < len(b):
        a, b = b, a
    if not b:
        return len(a)
    bb = np.frombuffer(b.encode(), np.uint8)
    m = bb.size
    js = np.arange(m + 1)
    base = np.empty(m + 1, np.int64)
    prev = js.astype(np.int64)
    for i, ca in enumerate(a.encode(), 1):
        # candidates without the insertion chain: deletion / substitution
        base[0] = i
        base[1:] = np.minimum(prev[1:] + 1, prev[:-1] + (bb != ca))
        # cur[j] = min_{t<=j} (base[t] + (j-t)) = j + prefix-min(base - t)
        prev = js + np.minimum.accumulate(base - js)
    return int(prev[-1])


def edit_distance_batch(a: str, bs) -> list:
    """``edit_distance(a, b)`` for every ``b`` in ``bs`` as ONE stacked DP
    (the same vectorized row recurrence with a leading pair axis); strings
    are padded to the longest and each result read at its own length —
    padding columns never influence earlier columns."""
    import numpy as np

    bs = list(bs)
    if not bs:
        return []
    if len(bs) == 1:
        return [edit_distance(a, bs[0])]
    P = len(bs)
    lens = np.fromiter((len(b) for b in bs), np.int64, P)
    m = int(lens.max())
    if m == 0:
        return [len(a)] * P
    bb = np.zeros((P, m), np.uint8)
    for p, b in enumerate(bs):
        eb = b.encode()
        bb[p, :len(eb)] = np.frombuffer(eb, np.uint8)
    js = np.arange(m + 1)
    prev = np.broadcast_to(js, (P, m + 1)).astype(np.int64).copy()
    base = np.empty((P, m + 1), np.int64)
    for i, ca in enumerate(a.encode(), 1):
        base[:, 0] = i
        np.minimum(prev[:, 1:] + 1, prev[:, :-1] + (bb != ca),
                   out=base[:, 1:])
        prev = js + np.minimum.accumulate(base - js, axis=1)
    return [int(prev[p, lens[p]]) for p in range(P)]


def find_diag_region(variants, groups, reference=None, nontarget=None,
                     primer3=False, min_vars=1, min_bases=1,
                     min_samp_prop=0.9, min_samples=5, min_reads=5,
                     min_geno_qual=30, min_map_qual=40, min_var_qual=10,
                     min_freq=0.1, crrna_len=28, tm=(53, 68), gc=(40, 70),
                     amp_size=(80, 300), primer_size=(25, 35), max_sec_tm=40,
                     gc_clamp=1, max_end_gc=4, var_location=(4, 16),
                     force=False, engine="host", device="cuda"):
    """Yield every window, tagged with .type; survivors are
    DiagnosticRegion instances (type == 'Diagnostic').  ``device`` is
    where ``engine="device"`` classifies ("cuda" or "cpu")."""
    offset_left = var_location[0] - 1
    offset_right = crrna_len - var_location[1]
    window_width = crrna_len - offset_right - offset_left

    classify_kwargs = dict(min_samp_prop=min_samp_prop,
                           min_samples=min_samples, min_reads=min_reads,
                           min_geno_qual=min_geno_qual, min_freq=min_freq,
                           min_map_qual=min_map_qual,
                           min_var_qual=min_var_qual, force=force)
    if engine == "device" and min_reads >= 1:
        from .device_classify import classify_stream_device
        reader = classify_stream_device(variants, groups, device=device,
                                        **classify_kwargs)
    else:
        reader = ClassifiedVariant.from_vcf(variants, groups,
                                            **classify_kwargs)
    windower = VariantWindow.sliding_window(
        reader, groups=list(groups.keys()), reference=reference,
        span=window_width, flank=amp_size[1])

    for region in windower:
        is_diag = [x is not None for x in region.diagnostic()]
        n_diag_var = sum(is_diag)
        if n_diag_var < min_vars:
            region.type = "Undiagnostic"
            yield region
            continue

        if any(x is None for x in region.conserved()):
            region.type = "Unconserved"
            yield region
            continue

        if n_diag_var == 1 and is_diag[-1] is False:
            region.type = "Misplaced"
            yield region
            continue

        yield cascade_tail(region, groups, reference, crrna_len=crrna_len,
                           var_location=var_location, min_bases=min_bases,
                           amp_size=amp_size, tm=tm, gc=gc,
                           primer_size=primer_size, max_sec_tm=max_sec_tm,
                           gc_clamp=gc_clamp, max_end_gc=max_end_gc)


class PendingDesign:
    """A window that passed cascade steps 4-6 and now only needs primer
    design: everything ``cascade_finish`` needs to type the region once a
    primer3 result arrives.  Lets the fast scan fuse the design screens of
    MANY windows into shared numpy rounds (design_primers_batch)."""

    __slots__ = ("region", "template_seq", "start_crrna_tmp", "crrna_seq",
                 "downstream_seq", "upstream_seq", "temp_range",
                 "crrna_range", "min_dist")

    def __init__(self, **kw):
        for k in self.__slots__:
            setattr(self, k, kw[k])

    @property
    def design_job(self):
        """(template, target_start, target_len) for run_primer3[_batch]."""
        return (self.template_seq, self.start_crrna_tmp,
                len(self.crrna_seq))


def cascade_tail(region, groups, reference, *, crrna_len, var_location,
                 min_bases, amp_size, tm, gc, primer_size, max_sec_tm,
                 gc_clamp, max_end_gc):
    """Cascade steps 4-7 (conserved overhangs/flanks, crRNA edit distance,
    primer design) for a window that passed the count/conserved/misplaced
    gates.  Returns the region with .type set; survivors come back as
    DiagnosticRegion.  Shared by the host scan and the vectorized
    prefilter (fastscan.py), which computes steps 1-3 in bulk and calls
    this only for the rare candidates.
    Parity: krisp_vcf.py:795-916."""
    from ..thermo.design import run_primer3

    pending = cascade_pre(region, groups, reference, crrna_len=crrna_len,
                          var_location=var_location, min_bases=min_bases,
                          amp_size=amp_size)
    if not isinstance(pending, PendingDesign):
        return pending
    p3_out = run_primer3(pending.template_seq,
                         target_start=pending.start_crrna_tmp,
                         target_len=len(pending.crrna_seq), tm=tm, gc=gc,
                         amp_size=amp_size, primer_size=primer_size,
                         max_sec_tm=max_sec_tm, gc_clamp=gc_clamp,
                         max_end_gc=max_end_gc)
    return cascade_finish(pending, p3_out)


def cascade_pre(region, groups, reference, *, crrna_len, var_location,
                min_bases, amp_size):
    """Cascade steps 4-6 (conserved overhangs/flanks, crRNA edit
    distance): returns the typed region on rejection, else a
    ``PendingDesign`` carrying the primer3 inputs."""
    offset_right = crrna_len - var_location[1]

    overhang_left = crrna_len - region.region_length() - offset_right
    overhang_right = offset_right
    overhang_up = consv_border_n(group=region.group,
                                 border_var=region.variants[-1],
                                 nearby_vars=region.upstream,
                                 max_offset=overhang_right)
    overhang_dn = consv_border_n(group=region.group,
                                 border_var=region.variants[0],
                                 nearby_vars=region.downstream,
                                 max_offset=overhang_left)
    if (overhang_up["group"] < offset_right
            or overhang_dn["group"] < overhang_left):
        region.type = "Unconserved"
        return region

    consv_up = consv_border_n(group=region.group,
                              border_var=region.variants[-1],
                              nearby_vars=region.upstream,
                              max_offset=amp_size[1])
    consv_dn = consv_border_n(group=region.group,
                              border_var=region.variants[0],
                              nearby_vars=region.downstream,
                              max_offset=amp_size[1])
    if consv_up["group"] - overhang_up["group"] < 30:
        region.type = "Unconserved"
        return region
    if consv_dn["group"] - overhang_dn["group"] < 30:
        region.type = "Unconserved"
        return region

    start_crrna_ref = region.variants[0].variant.pos - 1 - overhang_dn["ref"]
    end_crrna_ref = region.variants[-1].variant.pos - 1 + overhang_up["ref"]
    start_tmp_ref = region.variants[0].variant.pos - 1 - consv_dn["ref"]
    end_tmp_ref = region.variants[-1].variant.pos - 1 + consv_up["ref"]
    return cascade_from_ranges(region, groups, reference,
                               start_crrna_ref, end_crrna_ref,
                               start_tmp_ref, end_tmp_ref,
                               min_bases=min_bases)


def cascade_from_ranges(region, groups, reference, start_crrna_ref,
                        end_crrna_ref, start_tmp_ref, end_tmp_ref, *,
                        min_bases):
    """Cascade step 6 onward, given the crRNA/template reference ranges:
    consensus sequences, crRNA edit distance to every non-target group,
    primer3 inputs.  The serial path computes the ranges with per-window
    border walks (cascade_pre); the vectorized scan (fastscan) computes
    them for every candidate at once and joins back here."""
    crrna_seq = region.sequence(reference=reference, start=start_crrna_ref,
                                end=end_crrna_ref, group=region.group)
    nontarget_seqs = [
        region.sequence(reference=reference, start=start_crrna_ref,
                        end=end_crrna_ref, group=g)
        for g in groups if g is not region.group]
    min_dist = min(edit_distance_batch("".join(crrna_seq),
                                       ["".join(s) for s in nontarget_seqs]))
    if min_dist < min_bases:
        region.type = "Undiagnostic"
        return region

    downstream_seq = region.sequence(reference=reference,
                                     start=start_tmp_ref,
                                     end=start_crrna_ref - 1,
                                     group=region.group)
    upstream_seq = region.sequence(reference=reference,
                                   start=end_crrna_ref + 1,
                                   end=end_tmp_ref, group=region.group)
    template_seq = downstream_seq + crrna_seq + upstream_seq
    start_crrna_tmp = len(downstream_seq)

    return PendingDesign(
        region=region, template_seq=template_seq,
        start_crrna_tmp=start_crrna_tmp, crrna_seq=crrna_seq,
        downstream_seq=downstream_seq, upstream_seq=upstream_seq,
        temp_range=[start_tmp_ref, end_tmp_ref],
        crrna_range=[start_crrna_ref, end_crrna_ref], min_dist=min_dist)


def cascade_finish(pending, p3_out):
    """Cascade step 7: type the region from its primer3 result."""
    region = pending.region
    if p3_out["PRIMER_PAIR_NUM_RETURNED"] == 0:
        region.type = "No primers"
        return region

    region.type = "Diagnostic"
    return DiagnosticRegion.from_window(
        region, p3=p3_out, crrna_seq=pending.crrna_seq,
        downstream_seq=pending.downstream_seq,
        upstream_seq=pending.upstream_seq,
        temp_range=pending.temp_range,
        crrna_range=pending.crrna_range, min_bases=pending.min_dist)
