"""Sliding-window regions over classified variants + group consensus
sequence inference.

Semantics parity with the reference's ``GroupedRegion``
(reference src/krisp/krisp_vcf/krisp_vcf.py:143-479):

  - sliding_window: per group, a deque of in-window variants whose group-
    coordinate span stays <= ``span``, flanked by bounded upstream/downstream
    deques (window state is O(flank), the streaming analog of blockwise
    scanning).
  - region_length: reference span adjusted by each variant's max allele
    length delta (indel-aware).
  - sequence(): apply variants to the lowercased reference slice in reverse
    sorted order, with diagnostic-site uppercasing or ``<allele,count>``
    annotation (the alignment renderer's input).
  - ref_pos_from_group_offset: reference<->group coordinate transform
    accumulating allele-length deltas.
"""

from __future__ import annotations

from collections import deque

from ..dna import collapse_to_iupac


class _Ring:
    """Append-only variant buffer addressed by absolute stream index, with
    O(context) retained memory: ``trim`` drops everything below a bound
    once no live window can reference it."""

    __slots__ = ("_items", "_base")

    def __init__(self):
        self._items: list = []
        self._base = 0

    def append(self, item):
        self._items.append(item)

    def trim(self, upto: int):
        if upto > self._base:
            del self._items[: upto - self._base]
            self._base = upto

    def __getitem__(self, abs_index: int):
        return self._items[abs_index - self._base]

    @property
    def end(self) -> int:
        return self._base + len(self._items)


class _Span:
    """Immutable sequence view over a _Ring index range.  ``reverse=True``
    gives the nearest-first orientation of the downstream context.  Views
    are what sliding_window hands to each yielded window — no per-yield
    copying, no shared mutable state."""

    __slots__ = ("_ring", "_rng")

    def __init__(self, ring: _Ring, start: int, stop: int,
                 reverse: bool = False):
        self._ring = ring
        self._rng = (range(stop - 1, start - 1, -1) if reverse
                     else range(start, stop))

    def __len__(self):
        return len(self._rng)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self._ring[j] for j in self._rng[i]]
        return self._ring[self._rng[i]]

    def __iter__(self):
        for j in self._rng:
            yield self._ring[j]

    def __reversed__(self):
        for j in reversed(self._rng):
            yield self._ring[j]


def _consensus_tokens(var, group, annotate):
    """Tokens a variant splices into the assembled sequence.

    Case encodes diagnosticity (upper = allele diagnostic for ``group``);
    annotate mode emits one ``allele+count`` summary token at diagnostic
    sites, <>-wrapped when diagnostic for this group.  Token values are
    byte-visible output (reference: the replacement arm of
    krisp_vcf.py:404-436)."""
    if group is None:
        rep = var.variant.ref
    else:
        counts = var.allele_counts[group]
        diag_here = var.diagnostic[group] is not None
        if annotate and any(d is not None for d in var.diagnostic.values()):
            rep = ";".join(f"{a}{n}" for a, n in counts.items())
            if diag_here:
                rep = f"<{rep}>"
        else:
            rep = (collapse_to_iupac(counts.keys()) if counts
                   else "N" * var.variant.rlen)
            rep = rep.upper() if (annotate or diag_here) else rep.lower()
    return [rep] if annotate else list(rep)


def _apply_splices(base, cuts):
    """Assemble ``base`` tokens with each [rs, re) range replaced by its
    cut's tokens.  Cuts arrive ordered by reference end; disjoint cuts
    (the normal case) assemble left-to-right in one pass.  Overlapping
    loci keep right-fold semantics — each cut, in descending end order,
    splices at the previous assembly's token indices — which is what the
    byte-goldens pin."""
    if all(a[1] <= b[0] for a, b in zip(cuts, cuts[1:])):
        out, tail = [], 0
        for rs, re_, tokens in cuts:
            out += base[tail:rs]
            out += tokens
            tail = re_
        out += base[tail:]
        return out
    out = base
    for rs, re_, tokens in reversed(cuts):
        out = out[:rs] + tokens + out[re_:]
    return out


def group_span(variants, group) -> int:
    """Group-coordinate length of the reference interval covered by
    ``variants``: the span of the union of their reference loci, plus each
    variant's max observed allele-length delta for ``group`` (indel-aware;
    behavior target: the reference's ``region_length``,
    reference src/krisp/krisp_vcf/krisp_vcf.py:236-264)."""
    n = len(variants)
    if n == 0:
        return 0
    lo = hi = None
    length = 0
    for v in variants:
        start = v.variant.pos - 1
        end = start + v.variant.rlen - 1
        lo = start if lo is None else min(lo, start)
        hi = end if hi is None else max(hi, end)
        lens = v.allele_lens(group)
        if lens:
            length += max(lens.values()) - len(v.variant.ref)
    return length + hi - lo + 1


class VariantWindow:
    """A window of consecutive variants for one group (GroupedRegion parity)."""

    def __init__(self, variants, group, reference, upstream=None,
                 downstream=None):
        # any sequence-protocol container works (deque, list, _Span view);
        # plain iterables are materialized once
        self.variants = (variants if hasattr(variants, "__getitem__")
                         else deque(variants))
        self.group = group
        self.reference = reference  # dict chrom -> str sequence
        self.upstream = upstream if upstream is not None else ()
        self.downstream = downstream if downstream is not None else ()
        self.type = "Undetermined"

    # -- windowing -----------------------------------------------------------

    @classmethod
    def sliding_window(cls, variants, groups, reference, span, flank=1000):
        """Stream windows over classified variants, one per (variant, group).

        Own-idiom design (the same two-pointer formulation as the
        vectorized scan, fastscan._window_types): variants accumulate in a
        ring buffer; every stream index ``e`` becomes a window end once
        ``flank`` further variants are buffered (or the stream is
        exhausted), and each group's window start ``j`` advances
        monotonically until the group-coordinate span fits.  Yielded
        windows carry immutable views: in-window [j, e], lookahead
        (e, e+flank) exclusive of e, look-behind [j-flank, j) nearest
        first — the exact window sequence of the reference's deque
        machinery (krisp_vcf.py:171-218), pinned by the golden scan tests.
        """
        ring = _Ring()
        js = dict.fromkeys(groups, 0)

        def emit(e):
            for g in groups:
                j = js[g]
                while j <= e and group_span(_Span(ring, j, e + 1), g) > span:
                    j += 1
                js[g] = j
                if j <= e:
                    yield cls(variants=_Span(ring, j, e + 1), group=g,
                              reference=reference,
                              upstream=_Span(ring, e + 1, ring.end),
                              downstream=_Span(ring, max(j - flank, 0), j,
                                               reverse=True))

        n_read = 0
        for variant in variants:
            ring.append(variant)
            n_read += 1
            if n_read >= flank:
                e = n_read - flank
                yield from emit(e)
                ring.trim(max(min(js.values()) - flank, 0))
        for e in range(max(n_read - flank + 1, 0), n_read):
            yield from emit(e)
            ring.trim(max(min(js.values()) - flank, 0))

    # -- geometry ------------------------------------------------------------

    def region_length(self):
        return group_span(self.variants, self.group)

    def conserved(self):
        return [v.conserved[self.group] for v in self.variants]

    def diagnostic(self):
        return [v.diagnostic[self.group] for v in self.variants]

    # -- sequence inference (parity: krisp_vcf.py:359-443) ------------------

    def freeze(self):
        """Mark this window's deques as immutable-after-construction,
        enabling cached position arrays in ``sequence()``.

        Only for windows whose upstream/downstream deques are NOT the
        live sliding-window state: ``sliding_window`` yields windows that
        share its mutating deques (reference semantics — a later
        ``sequence()`` call sees the moved window), so those must never
        freeze.  The vectorized prefilter (fastscan.py) builds each
        candidate window fresh and never mutates it."""
        self._frozen = True
        return self

    def _frozen_arrays(self):
        cache = getattr(self, "_frozen", None)
        if cache is None or cache is False:
            return None
        if cache is True:
            import numpy as np
            all_vars = (list(self.downstream) + list(self.variants)
                        + list(self.upstream))
            n = len(all_vars)
            starts = np.fromiter((v.variant.pos for v in all_vars),
                                 np.int64, n) - 1
            ends = starts + np.fromiter((v.variant.rlen for v in all_vars),
                                        np.int64, n) - 1
            self._frozen = cache = (all_vars, starts, ends)
        return cache

    def _vars_touching(self, start, end):
        """Context variants whose reference locus starts or ends inside
        [start, end], in context order (behind-nearest-first, in-window,
        ahead)."""
        frozen = self._frozen_arrays()
        if frozen is not None:
            # cached position arrays: the cascade tail calls sequence()
            # several times per candidate window with the same variant set
            all_vars, starts_a, ends_a = frozen
            mask = (((start <= ends_a) & (ends_a <= end))
                    | ((start <= starts_a) & (starts_a <= end)))
            return [all_vars[i] for i in mask.nonzero()[0]]
        hits = []
        for v in (*self.downstream, *self.variants, *self.upstream):
            lo = v.variant.pos - 1
            hi = lo + v.variant.rlen - 1
            if start <= hi <= end or start <= lo <= end:
                hits.append(v)
        return hits

    def _splice_plan(self, start, end, group, annotate):
        """(cuts, chrom, pad_start, pad_end) for ``sequence``.

        Each cut is ``(rs, re, tokens)`` in token coordinates local to the
        padded slice [pad_start, pad_end]: drop base[rs:re], insert
        ``tokens``.  Cuts are ordered by reference end (stable), the order
        the byte-goldens pin for coincident loci."""
        sel = self._vars_touching(start, end)
        if len({v.variant.chrom for v in sel}) > 1:
            raise ValueError("Variants cannot span multiple chromosomes")
        chrom = self.variants[-1].variant.chrom
        if not sel:
            return [], chrom, start, end
        loci = [(v.variant.pos - 1, v.variant.pos + v.variant.rlen - 2)
                for v in sel]
        pad_start = min(start, min(lo for lo, _ in loci))
        pad_end = max(end, max(hi for _, hi in loci))
        order = sorted(range(len(sel)), key=lambda i: loci[i][1])
        cuts = []
        for i in order:
            rs = loci[i][0] - pad_start
            cuts.append((rs, rs + len(sel[i].variant.ref),
                         _consensus_tokens(sel[i], group, annotate)))
        return cuts, chrom, pad_start, pad_end

    def sequence(self, reference, start, end, group=None, annotate=False):
        """Group-consensus tokens over reference coords [start, end]
        (0-based inclusive): a splice plan over the context variants,
        assembled onto the lowercased reference slice, margins trimmed
        back to the requested range.  Token-for-token parity with the
        reference's GroupedRegion.sequence() (krisp_vcf.py:359-443) is
        pinned by the golden scan tests."""
        cuts, chrom, pad_start, pad_end = self._splice_plan(
            start, end, group, annotate)
        base = list(self._ref_slice(reference, chrom,
                                    pad_start, pad_end + 1).lower())
        out = _apply_splices(base, cuts)
        if pad_end > end:
            del out[len(out) - (pad_end - end):]
        if pad_start < start:
            del out[:start - pad_start]
        return out

    @staticmethod
    def _ref_slice(reference, chrom, start, stop):
        return str(reference[chrom][start:stop])

    # -- coordinate transform (parity: krisp_vcf.py:467-479) ----------------

    #: optional (pos 1-based, group delta) arrays over the window's context
    #: rows in ascending order — injected by the vectorized scan so the
    #: coordinate transform never touches variant objects
    _coords = None

    def _context_coords(self):
        """(pos 1-based, group allele-length delta) arrays over the
        window's context variants in ascending order; cached only on
        frozen windows (live sliding windows mutate under the caller)."""
        if self._coords is not None:
            return self._coords
        import numpy as np
        ctx = (list(reversed(self.downstream)) + list(self.variants)
               + list(self.upstream))
        n = len(ctx)
        coords = (
            np.fromiter((v.variant.pos for v in ctx), np.int64, n),
            np.fromiter(
                (v.max_allele_len(self.group) - len(v.variant.ref)
                 for v in ctx), np.int64, n),
        )
        if getattr(self, "_frozen", None):
            self._coords = coords
        return coords

    def ref_pos_from_group_offset(self, ref_pos, offset):
        """Reference position ``offset`` group-coordinate bases past
        ``ref_pos``: group coordinates drift from reference ones by the
        cumulative allele-length delta of the variants in between, so the
        answer is ref_pos + offset minus the drift accumulated before the
        first context position whose group offset reaches ``offset``
        (reference semantics: krisp_vcf.py:467-479)."""
        import numpy as np
        pos_arr, delta_arr = self._context_coords()
        d = (pos_arr - 1) - ref_pos
        add = np.where(d >= 0, delta_arr, 0)
        off_before = np.cumsum(add) - add
        stop = d + off_before >= offset
        if stop.any():
            off = off_before[np.argmax(stop)]
        else:
            off = off_before[-1] + add[-1] if add.size else 0
        return int(ref_pos + offset - off)


def consv_border_n(group, border_var, nearby_vars, max_offset):
    """Adjacent conserved run next to ``border_var``, in reference and
    group coordinates, capped at ``max_offset`` group bases.

    Array formulation: per nearby variant, its reference-coordinate gap
    to the border and the allele-length drift accumulated before it; the
    run ends at the first variant that crosses the cap in group
    coordinates or is not conserved in ``group``, else spans the whole
    neighborhood (reference semantics: krisp_vcf.py:579-609)."""
    import numpy as np
    nearby = (nearby_vars if hasattr(nearby_vars, "__getitem__")
              else list(nearby_vars))
    n = len(nearby)
    if n == 0:
        return {"ref": 0, "group": 0}
    bp = border_var.variant.pos
    init = (border_var.max_allele_len(group) - len(border_var.variant.ref)
            if bp < nearby[0].variant.pos else 0)
    pos = np.fromiter((v.variant.pos for v in nearby), np.int64, n)
    rlen = np.fromiter((len(v.variant.ref) for v in nearby), np.int64, n)
    delta = np.fromiter((v.max_allele_len(group) for v in nearby),
                        np.int64, n) - rlen
    # gap: distance border -> variant start (border left of it) or
    # variant end -> border (border right of it)
    gap = np.where(bp <= pos, pos - bp, bp - (pos + rlen - 1))
    drift = init + np.cumsum(delta) - delta  # drift before each variant
    stop = (gap + drift >= max_offset) | np.fromiter(
        (v.conserved[group] is None for v in nearby), bool, n)
    if stop.any():
        i = int(np.argmax(stop))
        if gap[i] + drift[i] >= max_offset:
            return {"ref": int(max_offset - drift[i]), "group": max_offset}
        return {"ref": int(gap[i]) - 1, "group": int(gap[i] + drift[i]) - 1}
    return {"ref": int(gap[-1] - init - delta.sum()), "group": int(gap[-1])}


class DiagnosticRegion(VariantWindow):
    """A window that survived the filter cascade, with primer results
    (parity: ``DiagosticRegion`` [sic], krisp_vcf.py:625-670)."""

    def __init__(self, variants, group, reference, upstream, downstream, p3,
                 crrna_seq, downstream_seq, upstream_seq, temp_range,
                 crrna_range, min_bases):
        super().__init__(variants, group, reference, upstream, downstream)
        self.p3 = p3
        self.downstream_seq = downstream_seq
        self.crrna_seq = crrna_seq
        self.upstream_seq = upstream_seq
        self.temp_range = temp_range
        self.crrna_range = crrna_range
        self.type = "Diagnostic"
        self.min_bases = min_bases

    @staticmethod
    def from_window(region, p3, crrna_seq, downstream_seq, upstream_seq,
                    temp_range, crrna_range, min_bases):
        out = DiagnosticRegion(
            variants=region.variants, group=region.group,
            reference=region.reference, upstream=region.upstream,
            downstream=region.downstream, p3=p3, crrna_seq=crrna_seq,
            downstream_seq=downstream_seq, upstream_seq=upstream_seq,
            temp_range=temp_range, crrna_range=crrna_range,
            min_bases=min_bases)
        frozen = getattr(region, "_frozen", None)
        if frozen:
            # frozen (prefilter-built) windows share immutable contexts;
            # adopt the source's cache as-is (a built position-array tuple
            # carries over without recomputation)
            out._frozen = frozen
        if region._coords is not None:
            out._coords = region._coords
        return out

    def left_range(self):
        start = self.ref_pos_from_group_offset(
            ref_pos=self.temp_range[0], offset=self.p3["PRIMER_LEFT_0"][0])
        end = self.ref_pos_from_group_offset(
            ref_pos=self.temp_range[0],
            offset=sum(self.p3["PRIMER_LEFT_0"]) - 1)
        return [start, end]

    def right_range(self):
        start = self.ref_pos_from_group_offset(
            ref_pos=self.temp_range[0],
            offset=self.p3["PRIMER_RIGHT_0"][0] - self.p3["PRIMER_RIGHT_0"][1] + 1)
        end = self.ref_pos_from_group_offset(
            ref_pos=self.temp_range[0], offset=self.p3["PRIMER_RIGHT_0"][0])
        return [start, end]

    def missing_samples(self):
        diag_vars = [v for v in self.variants
                     if v.diagnostic[self.group] is not None]
        return {sid for v in diag_vars
                for ids in v.missing_samp_ids.values() for sid in ids}
