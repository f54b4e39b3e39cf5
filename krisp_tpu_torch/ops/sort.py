"""Stable lexicographic sort of multi-word u32 keys (``krisp_tpu/ops/sort.py``).

Key words are int32 tensors holding u32 bit patterns, most significant
first.  Adjacent words fuse into one int64 digit whose signed order equals
the unsigned order of the word pair (the high word is biased by 2**31), so a
60-bit spacer key sorts in one ``torch.sort`` with nothing carried.  Wider
keys sort by least-significant-digit passes of stable sorts.

The port has one sort; the TPU's backend switch is not carried over.
"""

from __future__ import annotations

import torch

from ..convert import to_i32

_BIAS = -(1 << 31)   # XOR with INT32_MIN maps unsigned order to signed order


def _group64(keys):
    """Pair adjacent words (most significant first) into int64 digits; an
    odd trailing word stays an int32 digit.  Returns (digits, meta) with
    meta[i] = number of words in digit i.  Every digit's signed order is
    the unsigned order of its words."""
    groups, meta = [], []
    i = 0
    while i < len(keys):
        if i + 1 < len(keys):
            hi = (keys[i] ^ _BIAS).to(torch.int64)
            lo = keys[i + 1].to(torch.int64) & 0xFFFFFFFF
            groups.append((hi << 32) | lo)
            meta.append(2)
            i += 2
        else:
            groups.append(keys[i] ^ _BIAS)
            meta.append(1)
            i += 1
    return groups, meta


def _ungroup64(groups, meta):
    keys = []
    for g, m in zip(groups, meta):
        if m == 2:
            keys.append((g >> 32).to(torch.int32) ^ _BIAS)
            keys.append(to_i32(g))
        else:
            keys.append(g ^ _BIAS)
    return keys


def lsd_sort(keys, payloads=()):
    """Stable lexicographic sort by multi-word keys.

    keys: list of int32 tensors (u32 bit patterns), most significant first;
    payloads: tensors permuted with the rows.  Returns (keys_sorted list,
    payloads_sorted list): the order of krisp_tpu's ``lsd_sort``.
    """
    if not keys:
        return [], list(payloads)
    groups, meta = _group64(list(keys))
    if len(groups) == 1 and not payloads:
        # one digit and nothing carried: equal keys are indistinguishable,
        # so stability is void
        return _ungroup64([torch.sort(groups[0]).values], meta), []
    perm = None
    for g in reversed(groups):
        digit = g if perm is None else g[perm]
        order = torch.sort(digit, stable=True).indices
        perm = order if perm is None else perm[order]
    return (_ungroup64([g[perm] for g in groups], meta),
            [p[perm] for p in payloads])


#: krisp_tpu's name for the row sort; with no backend switch it is lsd_sort
sort_rows = lsd_sort
