"""Columnar batch conversion: VcfVariant records -> device arrays.

Bridges the streaming parser to the vectorized classification kernel
(ops/vcfclass.py).  Sample order follows the VCF columns; allele indices
follow (REF, *ALTs) order per variant.
"""

from __future__ import annotations

import numpy as np


def build_batch(variants, groups, max_alleles: int | None = None):
    """Pack a list of VcfVariant into arrays for ops.vcfclass.classify_batch.

    Returns (arrays dict, group_names list, sample_names list).
    Missing DP/GQ become -1; missing AD entries become 0 (matching the
    reference's ``0 if x is None else x`` handling,
    find_diag_var.py:256)."""
    variants = list(variants)
    if not variants:
        raise ValueError("empty batch")
    sample_names = list(variants[0].samples.keys())
    s_index = {s: i for i, s in enumerate(sample_names)}
    V, S = len(variants), len(sample_names)
    A = max_alleles or max(len(v.alleles) for v in variants)

    dp = np.full((V, S), -1, np.int32)
    gq = np.full((V, S), -1, np.int32)
    ad = np.zeros((V, S, A), np.int32)
    n_alleles = np.zeros(V, np.int32)
    mq = np.zeros(V, np.float32)
    qual = np.zeros(V, np.float32)

    for vi, var in enumerate(variants):
        n_alleles[vi] = len(var.alleles)
        mq[vi] = var.mq if var.mq is not None else -1
        qual[vi] = var.qual if var.qual is not None else -1
        for name, data in var.samples.items():
            si = s_index[name]
            if data.dp is not None:
                dp[vi, si] = data.dp
            if data.gq is not None:
                gq[vi, si] = data.gq
            for ai, d in enumerate(data.ad[:A]):
                if d is not None:
                    ad[vi, si, ai] = d

    group_names = list(groups.keys())
    group_id = np.full(S, -1, np.int32)
    for gi, (g, members) in enumerate(groups.items()):
        for m in members:
            if m in s_index:
                group_id[s_index[m]] = gi
    group_sizes = np.array([len(groups[g]) for g in group_names], np.int32)

    arrays = dict(dp=dp, gq=gq, ad=ad, n_alleles=n_alleles, mq=mq, qual=qual,
                  group_id=group_id, group_sizes=group_sizes)
    return arrays, group_names, sample_names
