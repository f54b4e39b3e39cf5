"""Result formatting + the single-writer aggregation layer for krisp_vcf.

Parity targets in the reference:
  - CSV schema (20+ fixed columns + primer3 stats): krisp_vcf.py:1045-1131
  - alignment block assembly: krisp_vcf.py:1134-1179
  - ResultWriter with the live rejection-reason status line:
    krisp_vcf.py:1217-1271
  - chunked scanning driver: krisp_vcf.py:993-1042, 1182-1212
"""

from __future__ import annotations

import sys
from collections import defaultdict

from .printer import Annotation, render_variant
from ..engine.render import PRIMER3_COL_NAMES, PRIMER3_COL_KEY


def format_p3_output(p3_out):
    return {PRIMER3_COL_KEY[n]: p3_out[n] for n in PRIMER3_COL_NAMES}


def format_for_csv(region, reference, groups):
    """One result row as an ordered dict (krisp_vcf.py:1065-1131)."""
    fwd_range = region.left_range()
    rev_range = region.right_range()
    crrna_range = region.crrna_range
    temp_range = region.temp_range

    chrom = region.variants[0].variant.chrom

    def format_seq(start, end):
        out = region.sequence(start=start, end=end, reference=reference,
                              group=region.group, annotate=False)
        return "".join(out)

    missing = region.missing_samples()

    output = {
        "region_id": f"{chrom}:{fwd_range[0] + 1}-{rev_range[1] + 1}",
        "group": region.group,
        "chrom": chrom,
        "n_diag": region.min_bases,
        "n_missing": len(missing),
        "reg_from": temp_range[0] + 1,
        "reg_to": temp_range[1] + 1,
        "diag_from": crrna_range[0] + 1,
        "diag_to": crrna_range[1] + 1,
        "fwd_from": fwd_range[0] + 1,
        "fwd_to": fwd_range[1] + 1,
        "rev_from": rev_range[0] + 1,
        "rev_to": rev_range[1] + 1,
        "missing_samp_ids": ";".join(missing),
        "seq_adj_left": format_seq(temp_range[0], fwd_range[0] - 1),
        "seq_primer_fwd": format_seq(fwd_range[0], fwd_range[1]),
        "seq_inter_left": format_seq(fwd_range[1] + 1, crrna_range[0] - 1),
        "seq_diag": format_seq(crrna_range[0], crrna_range[1]),
        "seq_inter_right": format_seq(crrna_range[1] + 1, rev_range[0] - 1),
        "seq_primer_rev": format_seq(rev_range[0], rev_range[1]),
        "seq_adj_right": format_seq(rev_range[1] + 1, temp_range[1]),
    }
    output.update(format_p3_output(region.p3))
    return output


def format_alignment(region, reference, groups):
    """Alignment block lines for one result (krisp_vcf.py:1134-1179)."""
    fwd_range = region.left_range()
    rev_range = region.right_range()
    crrna_range = region.crrna_range

    def fmt(group, start, end, annotate):
        return region.sequence(start=start, end=end, reference=reference,
                               group=group, annotate=annotate)

    group_seqs = {g: fmt(g, fwd_range[0], rev_range[1], True) for g in groups}
    ref_seq = fmt(None, fwd_range[0], rev_range[1], True)

    seq_primer_left = "".join(fmt(region.group, fwd_range[0], fwd_range[1], False))
    seq_primer_right = "".join(fmt(region.group, rev_range[0], rev_range[1], False))
    seq_crrna = "".join(fmt(region.group, crrna_range[0], crrna_range[1], False))
    oligos = [
        Annotation("Left primer", seq_primer_left, 0),
        Annotation("crRNA", seq_crrna, crrna_range[0] - fwd_range[0]),
        Annotation("Right primer", seq_primer_right,
                   rev_range[0] - fwd_range[0]),
    ]
    chrom = list(region.reference.keys())[0]
    output = [f"## {chrom}:{fwd_range[0] + 1}-{rev_range[1] + 1} "
              f"is diagnostic for {region.group}\n"]
    try:
        output += render_variant(seqs=group_seqs, ref=ref_seq, p3=region.p3,
                                 groups=groups, annots=oligos)
    except (IndexError, TypeError):
        output += ["CANNOT PRINT ALIGNMENT WITH OVERLAPPING INDELS"]
    output += ["\n"]
    return output


class ResultWriter:
    """Single-writer CSV/alignment/status aggregation
    (krisp_vcf.py:1217-1271)."""

    def __init__(self, output_stream, groups, align_path=None,
                 align_mode="w"):
        self.result_header_printed = False
        self.stat_header_printed = False
        self.output_stream = output_stream
        self.stat_names = ["Undiagnostic", "Unconserved", "No primers"]
        self.variant_counts = {s: 0 for s in self.stat_names}
        self.groups = list(groups)
        self.group_counts = {g: 0 for g in self.groups}
        self.align_path = align_path
        self.out_align = open(align_path, align_mode) if align_path else None

    def print_result(self, result):
        if not self.result_header_printed:
            print(*result.keys(), sep=",", file=self.output_stream, flush=True)
            self.result_header_printed = True
        print(*result.values(), sep=",", file=self.output_stream, flush=True)

    def _print_stats_header(self):
        width = max(len(n) for n in self.stat_names + self.groups)
        print("| ".join(n.ljust(width) for n in self.stat_names + self.groups),
              file=sys.stderr)

    def print_status(self, end_line=False):
        if not self.stat_header_printed:
            self._print_stats_header()
            self.stat_header_printed = True
        width = max(len(n) for n in self.stat_names + self.groups)
        cells = ([str(self.variant_counts[n]).ljust(width)
                  for n in self.stat_names]
                 + [str(self.group_counts[n]).ljust(width)
                    for n in self.groups])
        print("| ".join(cells), file=sys.stderr,
              end="\n" if end_line else "\r")

    def update_stats(self, output):
        if output["result"] is not None:
            self.group_counts[output["result"]["group"]] += 1
        for stat, count in output["stats"].items():
            if stat in self.variant_counts:
                self.variant_counts[stat] += count

    def write_alignment(self, lines):
        if self.out_align is not None:
            self.out_align.writelines([x + "\n" for x in lines] + ["\n"])

    def write(self, output):
        if output["result"] is not None:
            self.print_result(output["result"])
            self.write_alignment(output["alignment"])
        self.update_stats(output)
        self.print_status()

    def finish(self):
        print("", file=sys.stderr)
        if self.out_align is not None:
            self.out_align.close()

    def total_variants(self):
        return (sum(self.variant_counts.values())
                + sum(self.group_counts.values()))


# Record count above which ``--engine auto`` picks the device path:
# krisp_tpu's threshold, set for its one-time JAX compilation on large
# scans, kept as it is (routing changes which engine runs, never the bytes).
AUTO_DEVICE_MIN_RECORDS = 50_000


def resolve_engine(vcf_path, kwargs):
    """Map ``engine='auto'`` to 'device' for large indexed VCFs (where the
    vectorized prefilter amortizes compilation) and 'host' otherwise."""
    from .parser import VcfOffsetIndex

    engine = kwargs.get("engine", "host")
    if engine != "auto":
        return engine
    if (isinstance(vcf_path, VcfOffsetIndex)
            and vcf_path.n_records() >= AUTO_DEVICE_MIN_RECORDS):
        return "device"
    return "host"


def uses_device_fast_path(vcf_path, kwargs):
    """True when ``report_diag_region`` will take the array-native device
    scan (per-contig columnar slices + batched device classification) for
    this input.  Shared with the multicore driver so it never forks
    per-chunk workers around an in-process device scan.  Cheap: consults
    the index's allele width and the native library's availability, not a
    file parse."""
    from .parser import VcfOffsetIndex
    from ..io.native_vcf import get_lib

    if not isinstance(vcf_path, VcfOffsetIndex):
        return False
    if resolve_engine(vcf_path, kwargs) != "device":
        return False
    if kwargs.get("min_reads", 10) < 1:
        return False
    if get_lib() is None:
        return False
    # probe tokenizer + allele-width compatibility on this specific file
    # (O(1 record)) — a True here must mean the device scan actually runs,
    # or the multicore driver would give up its fork parallelism for a
    # single-process host fallback
    return vcf_path.native_ok()


def report_diag_region(vcf_path, chunk, groups, reference, want_alignment,
                       device="cuda", **kwargs):
    """Scan one chunk, yielding result/stats dicts (krisp_vcf.py:1182-1212).
    ``device`` is where the device engine classifies ("cuda" or "cpu")."""
    from .parser import VcfReader, VcfOffsetIndex
    from .scan import find_diag_region
    from ..metrics import GLOBAL as METRICS

    kwargs = dict(kwargs)
    kwargs["engine"] = resolve_engine(vcf_path, kwargs)

    if isinstance(vcf_path, VcfOffsetIndex) and chunk is None:
        # Sliding windows never span contigs (region.py raises on it, same
        # as the reference's per-chunk scans), so an unchunked scan over an
        # indexed VCF runs one scan per contig in file order — on BOTH
        # engines (the device prefilter's positional two-pointer assumes a
        # single coordinate system; a single-contig fetch here used to drop
        # every contig after the first on the host path).
        for contig, _ in vcf_path.contigs:
            yield from report_diag_region(
                vcf_path, {"contig": contig, "start": None, "end": None},
                groups, reference, want_alignment, device=device, **kwargs)
        return

    if uses_device_fast_path(vcf_path, kwargs):
        # array-native fast path: per-contig columnar slice -> batched
        # device classification -> vectorized window prefilter; identical
        # typed-window stream to the host scan (tests/test_fastscan.py).
        # Slice loading bounds memory by the contig block, not the file.
        with METRICS.stage("columnar"):
            col = vcf_path.columnar_slice(chunk["contig"])
        if col is not None:
            from .fastscan import find_diag_region_fast, chunk_rows
            regions = find_diag_region_fast(
                col, chunk_rows(col, chunk), groups, reference,
                device=device, **kwargs)
            yield from _drain_regions(regions, reference, groups,
                                      want_alignment)
            return

    if isinstance(vcf_path, VcfOffsetIndex):
        # seek-based chunk access: O(chunk) per fetch, O(file) total across
        # all workers (the tabix-equivalent fast path); chunk=None was
        # rewritten into per-contig chunks above
        variants = vcf_path.fetch(chunk["contig"], start=chunk["start"],
                                  end=chunk["end"])
    elif chunk is None:
        variants = iter(VcfReader(vcf_path))
    else:
        variants = VcfReader(vcf_path).fetch(chunk["contig"],
                                             start=chunk["start"],
                                             end=chunk["end"])
    yield from _drain_regions(
        find_diag_region(variants, groups, reference, device=device,
                         **kwargs),
        reference, groups, want_alignment)


def _drain_regions(regions, reference, groups, want_alignment):
    """Typed-window stream -> result/stats batch dicts (shared by the host
    and fast scan paths); formatting a result is the ``render`` stage."""
    from ..metrics import GLOBAL as METRICS

    stats = defaultdict(int)
    undiag = 0
    update_interval = 1000
    for region in regions:
        stats[region.type] += 1
        if region.type == "Diagnostic":
            with METRICS.stage("render"):
                result = format_for_csv(region, reference, groups)
                alignment = (format_alignment(region, reference, groups)
                             if want_alignment else None)
            yield {"result": result, "stats": stats, "alignment": alignment}
            stats = defaultdict(int)
        else:
            undiag += 1
        if undiag >= update_interval:
            yield {"result": None, "stats": stats, "alignment": None}
            undiag = 0
            stats = defaultdict(int)


def make_chunks(reference, contigs_in_vcf, chunk_size=100000, flank_size=1000,
                contig_subset=None, pos_subset=None):
    """Contig x chunk grid with flank overlap (krisp_vcf.py:993-1042)."""
    if pos_subset is not None:
        pos_len = max(pos_subset) - min(pos_subset) + 1
        if pos_len < chunk_size:
            chunk_size = pos_len
    output = []
    for contig in contigs_in_vcf:
        if contig_subset is not None and contig not in contig_subset:
            continue
        if pos_subset is None:
            search_start, search_end = 0, len(reference[contig])
        else:
            search_start = min(pos_subset) - 1
            search_end = max(pos_subset) - 1
        for start in range(search_start, search_end, chunk_size):
            end = start + chunk_size + flank_size
            if start > flank_size:
                start -= flank_size
            output.append({"contig": contig, "start": start, "end": end})
    return output
