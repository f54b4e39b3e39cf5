"""Per-variant, per-group genotype classification.

Semantics parity with the reference's ``GroupedVariant``
(reference src/krisp/krisp_vcf/find_diag_var.py:128-438):

  - quality-gated sample counting (DP >= min_reads, GQ >= min_geno_qual)
  - AD-based allele calling with a read-frequency floor (min_freq)
  - '?' pseudo-allele for zero-coverage samples (only reachable when
    min_reads == 0, e.g. in the rendering paths)
  - conserved allele per group (single allele + sample-count/proportion +
    MQ/QUAL gates)
  - diagnostic allele per group (conserved and absent from all other groups)

Dict orderings (first-seen over VCF sample-column order; alleles sorted
within a sample) are preserved because they are visible in rendered output.

This module is the exact host-side engine; ops/vcfclass.py provides the
vectorized device equivalent for batch scanning.
"""

from __future__ import annotations

import csv

UNKNOWN_CHAR = "?"
HETERO_DELIM = "/"


def parse_group_data(metadata_path, groups=None, sample_col="sample_id",
                     group_col="group", min_samples=None):
    """Metadata CSV -> {group: [sample ids]} with the reference's
    validation (find_diag_var.py:24-61)."""
    output: dict[str, list[str]] = {}
    with open(metadata_path, newline="") as handle:
        for row in csv.DictReader(handle):
            output.setdefault(row[group_col], []).append(row[sample_col])
    if groups is not None:
        missing = [g for g in groups if g not in output]
        if missing:
            raise ValueError(
                f"One or more user-defined groups are not present in the "
                f"metadata file:\n    {metadata_path}\n"
                f"The following user-defined groups are not present:\n"
                f"    {', '.join(missing)}\n"
                f"The following groups are present in the metadata file:\n"
                f"    {', '.join(output.keys())}")
    if min_samples is not None and groups is not None:
        too_few = {g: len(v) for g, v in output.items()
                   if g in groups and len(v) < min_samples}
        if too_few:
            raise ValueError(
                "One or more user-defined groups have fewer samples than "
                "`--min_samples`:\n    "
                + ", ".join(f"{g} ({c})" for g, c in too_few.items()))
    if groups is not None:
        output = {g: v for g, v in output.items() if g in groups}
    return output


def count_genotypes(variant, subset=None, hetero=True, unknown=True,
                    min_reads=0, min_geno_qual=0, min_freq=0.1):
    """Allele-string counts over a sample subset (parity:
    find_diag_var.py:203-270)."""
    if subset is None:
        subset = variant.samples.keys()
    subset = [s for s in subset
              if variant.samples[s]["DP"] is not None
              and variant.samples[s]["DP"] >= min_reads
              and variant.samples[s]["GQ"] is not None
              and variant.samples[s]["GQ"] >= min_geno_qual]
    subset_set = set(subset)
    counts: dict[str, int] = {}
    for sample_id, data in variant.samples.items():
        if sample_id not in subset_set:
            continue
        if data["DP"] == 0:
            alleles = UNKNOWN_CHAR
        else:
            depth = [0 if x is None else x for x in data["AD"]]
            min_depth = sum(depth) * min_freq
            alleles = sorted({variant.alleles[i]
                              for i, d in enumerate(depth)
                              if d > 0 and d >= min_depth})
            alleles = [UNKNOWN_CHAR if a is None else a for a in alleles]
            if hetero:
                alleles = [HETERO_DELIM.join(alleles)]
        for allele in alleles:
            counts[allele] = counts.get(allele, 0) + 1
    if not unknown:
        counts = {k: v for k, v in counts.items() if k != UNKNOWN_CHAR}
    return counts


def subset_sample_counts(variant, subset, min_reads=10, min_geno_qual=40):
    """Samples passing gates + ids of those failing (parity:
    find_diag_var.py:389-398)."""
    is_good = {s: variant.samples[s]["DP"] is not None
                  and variant.samples[s]["DP"] >= min_reads
                  and variant.samples[s]["GQ"] is not None
                  and variant.samples[s]["GQ"] >= min_geno_qual
               for s in subset}
    return {"counts": sum(is_good.values()),
            "missing": {k for k, v in is_good.items() if not v}}


class ClassifiedVariant:
    """One variant classified per sample-group (GroupedVariant parity)."""

    def __init__(self, variant, groups, check_groups=False, min_samp_prop=0.9,
                 min_samples=5, min_reads=10, min_geno_qual=40, min_freq=0.1,
                 min_map_qual=30, min_var_qual=10, force=False):
        self.variant = variant
        if check_groups:
            meta_samples = {s for ids in groups.values() for s in ids}
            vcf_samples = set(variant.samples.keys())
            missing_in_vcf = meta_samples - vcf_samples
            if missing_in_vcf and not force:
                raise ValueError(
                    "The following samples specified in the metadata cannot "
                    "be found in the VCF input:\n    "
                    + ", ".join(missing_in_vcf) + "\n")
            self.groups = {g: [s for s in ids if s in vcf_samples]
                           for g, ids in groups.items()}
        else:
            self.groups = groups
        self.min_samples = min_samples
        self.min_reads = min_reads
        self.min_geno_qual = min_geno_qual
        self.min_freq = min_freq

        self.sample_counts = {}
        self.missing_samp_ids = {}
        for g, samples in self.groups.items():
            res = subset_sample_counts(variant, samples, min_reads,
                                       min_geno_qual)
            self.sample_counts[g] = res["counts"]
            self.missing_samp_ids[g] = res["missing"]

        self.allele_counts = {
            g: count_genotypes(variant, samples, hetero=False,
                               min_reads=min_reads,
                               min_geno_qual=min_geno_qual,
                               min_freq=min_freq)
            for g, samples in self.groups.items()}

        self.conserved = self._conserved(min_samp_prop, min_samples,
                                         min_map_qual, min_var_qual)
        self.diagnostic = self._diagnostic(min_samp_prop, min_samples,
                                           min_map_qual, min_var_qual)

    @classmethod
    def from_vcf(cls, variants, groups, **kwargs):
        """Stream of ClassifiedVariant; group membership validated once
        (parity: find_diag_var.py:187-201)."""
        checked = False
        for var in variants:
            if checked:
                out = cls(var, groups, check_groups=False, **kwargs)
            else:
                out = cls(var, groups, check_groups=True, **kwargs)
                groups = out.groups
                checked = True
            yield out

    def _quality_fail(self, min_map_qual, min_var_qual):
        return (self.variant.info["MQ"] < min_map_qual
                or self.variant.qual < min_var_qual)

    def _conserved(self, min_samp_prop, min_samples, min_map_qual,
                   min_var_qual):
        if self._quality_fail(min_map_qual, min_var_qual):
            return {g: None for g in self.groups}
        out = {}
        for g, counts in self.allele_counts.items():
            prop = self.sample_counts[g] / len(self.groups[g])
            if (len(counts) == 1 and self.sample_counts[g] >= min_samples
                    and prop >= min_samp_prop):
                out[g] = next(iter(counts))
            else:
                out[g] = None
        return out

    def _diagnostic(self, min_samp_prop, min_samples, min_map_qual,
                    min_var_qual):
        if self._quality_fail(min_map_qual, min_var_qual):
            return {g: None for g in self.groups}
        if any(n < min_samples or n / len(self.groups[g]) < min_samp_prop
               for g, n in self.sample_counts.items()):
            return {g: None for g in self.groups}
        alleles = {g: set(self.allele_counts[g]) for g in self.groups}
        diag = {}
        for g in self.groups:
            others = set()
            for og in self.groups:
                if og != g:
                    others |= alleles[og]
            unique = alleles[g] - others
            if len(alleles[g]) > 1 or not unique:
                diag[g] = None
            else:
                diag[g] = next(iter(unique))
        return diag

    def allele_lens(self, group):
        """Nucleotide length per allele (parity: find_diag_var.py:413-431)."""
        out = {}
        for allele in self.allele_counts[group]:
            if HETERO_DELIM in allele:
                out[allele] = max(len(x) for x in allele.split(HETERO_DELIM))
            elif allele == "*":
                out[allele] = 0
            else:
                out[allele] = len(allele)
        return out

    def max_allele_len(self, group):
        if not self.allele_counts[group]:
            return len(self.variant.ref)
        return max(self.allele_lens(group).values())
