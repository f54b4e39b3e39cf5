"""Range-partitioned global stage of the out-of-core path
(``krisp_tpu/engine/bigscale.py``).

Per-genome tables arrive as sorted sub-runs (one per extraction chunk,
``engine.pipeline._genome_table_chunked``) in host memory.  Ranges of the
leading flank bits, balanced by a histogram, cut the rows into passes of at
most ``row_budget_for(layout)`` rows (a flank group never straddles two
ranges), each range is sliced out of every sub-run by binary search, and
each pass uploads its rows and runs ``ops.intersect.global_intersect_bits``
(as ``global_intersect_rows``, which frees the pass's table once sorted) on
the card.  Survivors concatenate in range order, which is global key
order, with group ids offset per pass by the largest kept id + 1: the
result equals krisp_tpu's staged path bit for bit.

``row_budget_for``, ``_prefix_ranges``, ``_range_bounds`` and
``_slice_range`` are copies of krisp_tpu's JAX-free helpers (pinned equal by
tests/test_torch_bigscale.py).  krisp_tpu pads every pass to one common
size (``KRISP_TPU_GLOBAL_PAD``) so that all passes share one compiled XLA
program, and retries a pass whose survivors overflow its compaction
``cap``.  PyTorch compiles nothing and compacts exactly, so the port has
neither; nor does it have the undocumented ``KRISP_TPU_PROGRESS`` pass
counter on stderr (``--verbose`` reports the stages).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..budget import ROW_LIMIT
from ..convert import keys_to_numpy
from ..device import resolve_device
from ..metrics import GLOBAL as METRICS
from ..ops.intersect import global_intersect_rows


def row_budget_for(layout) -> int:
    """Rows per global-stage pass.  KRISP_TPU_GLOBAL_ROWS pins it
    directly; otherwise KRISP_TPU_GLOBAL_BYTES (default 2 GiB) divided by
    the per-row device footprint (key words + carried count)."""
    rows = int(os.environ.get("KRISP_TPU_GLOBAL_ROWS", 0))
    if rows > 0:
        return rows
    budget = int(os.environ.get("KRISP_TPU_GLOBAL_BYTES", 2 << 30))
    return max(budget // (4 * (layout.n_words + 1)), 1 << 16)


def _prefix_ranges(parts, shift, n_buckets, row_budget):
    """Greedy prefix-bucket ranges of at most ``row_budget`` rows (a
    single over-full bucket becomes its own range — it cannot split at
    this prefix width).  Returns list of (lo, hi) bucket intervals."""
    hist = np.zeros(n_buckets, np.int64)
    for words, _counts, offsets in parts:
        hist += np.bincount(words[0] >> shift, minlength=n_buckets)
    ranges = []
    lo = 0
    acc = 0
    for b in range(n_buckets):
        if acc and acc + hist[b] > row_budget:
            ranges.append((lo, b))
            lo, acc = b, 0
        acc += int(hist[b])
    ranges.append((lo, n_buckets))
    return ranges


def _range_bounds(parts, shift, blo, bhi):
    """Per-sub-run row intervals whose flank prefix falls in [blo, bhi):
    two binary searches per sub-run, no data movement."""
    vlo = np.uint32(blo << shift)
    bounds = []
    for words, _counts, offsets in parts:
        w0 = words[0]
        per_part = []
        for s, e in zip(offsets[:-1], offsets[1:]):
            seg = w0[s:e]
            a = s + np.searchsorted(seg, vlo, side="left")
            if bhi << shift > 0xFFFFFFFF:
                b = e
            else:
                b = s + np.searchsorted(seg, np.uint32(bhi << shift),
                                        side="left")
            per_part.append((int(a), int(b)))
        bounds.append(per_part)
    return bounds


def _slice_range(parts, bounds):
    """Materialize the rows selected by ``_range_bounds`` (lazy: called
    one range at a time so peak host memory stays one range, not the
    whole table twice)."""
    out_w, out_c = [], []
    for (words, counts, _offsets), per_part in zip(parts, bounds):
        for a, b in per_part:
            if b > a:
                out_w.append(words[:, a:b])
                out_c.append(counts[a:b])
    if not out_w:
        return None, None
    return np.concatenate(out_w, axis=1), np.concatenate(out_c)


def _empty(W):
    return (np.zeros((0, W), np.uint32), np.zeros(0, np.uint32),
            np.zeros(0, np.int64))


def partitioned_global_intersect(parts, layout, n_files: int,
                                 row_budget: int | None = None,
                                 stats: dict | None = None, device="cuda"):
    """Global stage over per-genome sorted sub-run tables, in bounded
    passes on ``device``.

    parts: list of (words uint32[W, n], counts uint32[n], offsets
    int64[k+1]): KeyLayout rows with the genome id OR'd in, no sentinel
    rows, sorted within each offsets-delimited sub-run.

    Returns (words uint32[n_keep, W], counts uint32[n_keep], group_id
    int64[n_keep]) in global key order: krisp_tpu's staged result.  Each
    pass runs in the stage ``global_pass``.
    """
    dev = resolve_device(device)
    W = layout.n_words
    if row_budget is None:
        row_budget = row_budget_for(layout)
    # a pass's sort takes fewer rows than the kernels' limit (a prefix
    # bucket fuller than that still makes one pass, which the kernel
    # refuses)
    row_budget = min(row_budget, ROW_LIMIT - 1)
    total = sum(p[0].shape[1] for p in parts)
    if total == 0:
        return _empty(W)

    B = min(16, layout.flank_bits)
    shift = 32 - B
    if total <= row_budget:
        ranges = [(0, 1 << B)]
    else:
        with METRICS.stage("global_ranges", items=total):
            ranges = _prefix_ranges(parts, shift, 1 << B, row_budget)
    if stats is not None:
        stats["global_rows"] = total
        stats["global_passes"] = len(ranges)
        stats["row_budget"] = row_budget

    out_w, out_c, out_g = [], [], []
    gid_base = 0
    for blo, bhi in ranges:
        with METRICS.stage("global_slice"):
            w, c = _slice_range(parts, _range_bounds(parts, shift, blo,
                                                     bhi))
        if w is None:
            continue
        n = w.shape[1]
        with METRICS.stage("global_pass", items=n, device=dev):
            # words and counts upload into one [W + 1, n] table, which the
            # stage frees once sorted
            table = torch.empty((W + 1, n), dtype=torch.int32, device=dev)
            table[:W].copy_(torch.from_numpy(w.view(np.int32)))
            table[W].copy_(torch.from_numpy(c.view(np.int32)))
            del w, c
            table = [table]
            words_k, cnt_k, gid_k = global_intersect_rows(table, layout,
                                                          n_files)
            if gid_k.numel():
                out_w.append(keys_to_numpy(words_k).T)
                out_c.append(keys_to_numpy(cnt_k))
                gids = gid_k.cpu().numpy().astype(np.int64)
                out_g.append(gids + gid_base)
                gid_base += int(gids.max()) + 1

    if not out_w:
        return _empty(W)
    return (np.concatenate(out_w, axis=0), np.concatenate(out_c),
            np.concatenate(out_g))
