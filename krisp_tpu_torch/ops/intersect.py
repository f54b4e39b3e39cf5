"""Multi-way intersection of per-genome k-mer key tables
(``krisp_tpu/ops/intersect.py``).

Every genome's windows become sentinel-marked KeyLayout keys with the genome
id in the key (``extract_keys_packed_in`` from the 2-bit host pack,
``extract_keys_ascii`` from the raw bytes on the 4-bit route); the global
stage (``global_stage``) sorts them, marks survivors (flank groups present
in all genomes) and compacts them.  Wide keys first pass the prefilter
(``prefilter_rows``): it sorts one prefix|genome word with row ids, keeps
the rows whose flank prefix group spans all genomes, and the exact
full-width stage runs on those rows only.

The out-of-core path collapses each chunk's sorted keys with
``dedup_sorted`` and runs ``global_intersect_bits`` per key range: the rows
carry their multiplicities, which ``survivor_mark_weighted`` sums per run.

PyTorch sizes outputs at run time, so compaction is one ``torch.nonzero``
(one host sync, exact size).  The TPU's capped compaction, its padding and
its overflow retries are not needed.
"""

from __future__ import annotations

import torch

from ..convert import i32, to_i32
from ..metrics import GLOBAL as METRICS
from .encode import KeyLayout, window_keys_bits
from .pack import SENTINEL, window_keys_table
from .scan import _masked_head, _run_heads, survivor_scan_layout
from .sort import sort_with_rowid, sort_words


def unpack_genomes(packed: torch.Tensor, vbits: torch.Tensor) -> torch.Tensor:
    """Inverse of ``engine.pipeline._pack_genomes_host``: 2-bit codes
    (int32[F, nw], base k of a word at bits 2k) + validity bitmap
    (uint8[F, nv], little-endian bits) -> ASCII uint8[F, 16 nw] with A/C/G/T
    at valid bases and N elsewhere."""
    F, nw = packed.shape
    k = torch.arange(16, dtype=torch.int32, device=packed.device) * 2
    codes = ((packed[:, :, None] >> k) & 3).reshape(F, nw * 16)
    b = torch.arange(8, dtype=torch.uint8, device=vbits.device)
    valid = (((vbits[:, :, None] >> b) & 1) == 1).reshape(F, -1)
    # A=65 C=67 G=71 T=84: 65 + 2*code, +2 at code >= 2, +11 at code 3
    ascii_ = 65 + 2 * codes + 2 * (codes >= 2) + 11 * (codes == 3)
    return torch.where(valid, ascii_, ord("N")).to(torch.uint8)


def _all_window_keys(buffer: torch.Tensor, file_idx: int, left: int,
                     mid: int, right: int, bits: int, n_files: int,
                     tables=None, omit_soft: bool = False,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """Window keys of one genome buffer (uint8[P]), forward then reverse
    strand: int32[W, 2 n_win] with genome id ``file_idx`` OR'd in and
    windows that are not all valid bases set to SENTINEL; written into
    ``out`` (an int32[W, 2 n_win] view) when given.

    2-bit keys come from the window-key kernel's table mode, whose
    validity is A/C/G/T by arithmetic (not lower case under
    ``omit_soft``), in one launch that writes ``out`` directly; other
    widths from ``window_keys_bits`` with ``tables`` = (code, valid, comp)
    per-byte tables, which carry the softmask policy."""
    if bits == 2:
        return window_keys_table(buffer, file_idx, left, mid, right,
                                 n_files, omit_soft, out)
    layout = KeyLayout(left, mid, right, bits, n_files)
    fword, fshift = layout.file_word_shift()
    ok, words = window_keys_bits(buffer, *tables, left, mid, right, bits,
                                 n_files)
    words = torch.stack(words)
    words[fword] |= i32(file_idx << fshift)
    words = torch.where(ok, words, SENTINEL)
    if out is None:
        return words
    out.copy_(words)
    return out


def extract_keys_packed_in(packed_row: torch.Tensor, vbits_row: torch.Tensor,
                           file_idx: int, left: int, mid: int, right: int,
                           bits: int, n_files: int,
                           out: torch.Tensor | None = None) -> torch.Tensor:
    """Sentinel-marked KeyLayout keys of ONE genome (both strands) with
    genome id ``file_idx`` OR'd in.

    packed_row / vbits_row: int32[1, nw] / uint8[1, nv], one genome of
    ``engine.pipeline._pack_genomes_host``.  Returns int32[W, 2 n_win],
    written into ``out`` when given.
    """
    buffer = unpack_genomes(packed_row, vbits_row)[0]
    return _all_window_keys(buffer, file_idx, left, mid, right, bits, n_files,
                            out=out)


def extract_keys_ascii(buffer: torch.Tensor, file_idx: int, tables,
                       left: int, mid: int, right: int, bits: int,
                       n_files: int,
                       out: torch.Tensor | None = None) -> torch.Tensor:
    """``extract_keys_packed_in`` for the 4-bit route: one genome's raw
    ASCII bytes (uint8[P]) and the (code, valid, comp) tables of
    ``engine.pipeline._encoding_tables``, which carry the softmask
    policy.  Returns int32[W, 2 n_win], written into ``out`` when
    given."""
    if bits == 2:
        raise ValueError("2-bit keys come from extract_keys_packed_in")
    return _all_window_keys(buffer, file_idx, left, mid, right, bits,
                            n_files, tables, out=out)


def dedup_sorted(words: torch.Tensor, n_valid: int):
    """Collapse the duplicate rows of a sorted table without compaction
    (krisp_tpu's ``dedup_sorted``).

    words: int32[W, n] sorted, its ``n_valid`` valid rows first.  Returns
    (words int32[W, n], counts int32[n]): head rows keep their words and
    get the run length, clipped at ``n_valid``, as count; duplicate and
    invalid rows become SENTINEL rows with count 0.  The next head comes
    from a gather at the run heads, not a reverse running minimum."""
    n = words.shape[1]
    counts = torch.zeros(n, dtype=torch.int32, device=words.device)
    if n == 0:
        return words, counts
    head = _run_heads(words)
    head[n_valid:] = False
    heads = torch.nonzero(head).squeeze(1)
    nxt = torch.cat([heads[1:], heads.new_full((1,), n_valid)])
    counts[heads] = (nxt - heads).to(torch.int32)
    return torch.where(head, words, SENTINEL), counts


def compact_rows(arrays, keep: torch.Tensor):
    """The rows of each array (last axis) where ``keep`` holds, in order;
    returns (compacted arrays, n_keep)."""
    idx = torch.nonzero(keep).squeeze(1)
    return [a[..., idx] for a in arrays], idx.numel()


def prefilter_rows(flat: torch.Tensor, layout: KeyLayout,
                   n_files: int) -> torch.Tensor:
    """Row ids (int64) of the rows of sentinel-marked keys int32[W, n]
    whose flank prefix group spans all ``n_files`` genomes.

    The prefix key is the leading ``32 - file_bits`` bits of word 0 with the
    genome id in the low ``file_bits``; sorted with row ids, the survivor
    test of ``survivor_mark_bits`` runs over it with the prefix as the
    flank.  The survivors are a superset of the true survivor set, and
    every flank group inside a surviving prefix group is kept whole."""
    n = flat.shape[1]
    if n == 0:
        return torch.zeros(0, dtype=torch.int64, device=flat.device)
    fw, fsh = layout.file_word_shift()
    fb, sent = layout.file_bits, layout.file_sentinel
    # temporaries are dropped as soon as they are dead: beside the table,
    # they set the peak device memory of the wide-key paths
    field = (flat[fw] >> fsh) & sent
    pk = (flat[0] & i32((0xFFFFFFFF >> fb) << fb)) | field
    del field
    pk_s, rowid = sort_with_rowid(pk)
    del pk
    head_pre = _masked_head(pk_s[None], 32 - fb)
    valid = (pk_s & sent) != sent
    x = _run_heads(pk_s[None]) & valid
    del pk_s
    c = torch.cumsum(x, 0)
    # krisp_tpu's base (a running max of c - x at group heads) and endc (a
    # reverse running min of c at group tails) are, as c never decreases,
    # the values at the row's own group head and tail: two gathers.  With
    # torch.cummax and torch.cummin this stage took 0.25 s at 40.6M rows
    # on an H100, against 0.012 s
    heads = torch.nonzero(head_pre).squeeze(1)
    tails = torch.cat([heads[1:] - 1, heads.new_full((1,), n - 1)])
    genomes = c[tails] - c[heads] + x[heads]   # distinct valid genomes
    del c, x, heads, tails
    group = torch.cumsum(head_pre, 0)
    group -= 1
    survive = genomes[group] == n_files
    del group, genomes
    survive &= valid
    (kept,), _ = compact_rows([rowid], survive)
    return kept


def global_stage(table: list, layout: KeyLayout, n_files: int,
                 prefilter: bool | None = None):
    """The global stage over sentinel-marked keys: [prefilter ->] sort ->
    survivor scan -> compaction.

    ``table`` is a one-element list holding the keys int32[W, n]; the
    stage takes the tensor out of it, so the table is freed as soon as the
    stage is done with it (after the prefilter's gather, or after the
    sort).  ``prefilter`` None applies krisp_tpu's gate: wide keys whose
    first word is all flank take the one-word prefix prefilter.  Returns
    (words int32[W, n_keep], counts int32[n_keep], gid int32[n_keep],
    n_pre): krisp_tpu's packed rows ``[:W, :n_keep]``, ``[W, :n_keep]``,
    ``[W + 1, :n_keep]`` and the rows the prefilter kept (n without it).
    Group ids equal krisp_tpu's: its cap padding is sentinel rows, which
    sort last."""
    flat = table.pop()
    dev = flat.device
    if prefilter is None:
        prefilter = layout.n_words > 2 and layout.flank_bits >= 32
    n_pre = flat.shape[1]
    if prefilter:
        with METRICS.stage("prefilter", items=n_pre, device=dev):
            kept = prefilter_rows(flat, layout, n_files)
        n_pre = kept.numel()
        with METRICS.stage("gather", items=n_pre, device=dev):
            flat = flat[:, kept]
        del kept
    with METRICS.stage("sort", items=n_pre, device=dev):
        keys = sort_words(flat)   # sort_rows' backend, without its list
    del flat
    with METRICS.stage("scan", device=dev):
        keep, counts, gid = survivor_scan_layout(keys, layout, n_files)
    with METRICS.stage("compact", device=dev):
        (words, counts, gid), _ = compact_rows([keys, counts, gid], keep)
    return words, counts, gid, n_pre


def _run_sums(weights: torch.Tensor, runs: torch.Tensor,
              rows: torch.Tensor) -> torch.Tensor:
    """The sums of ``weights`` (int32 holding u32) over the runs that
    start at ``rows`` and span ``runs[rows]`` rows, modulo 2**32 as int32
    bit patterns: krisp_tpu's wrapping uint32 sum.  The int32 words summed
    as signed values agree with the u32 sum modulo 2**32, and an int64
    prefix sum of n < 2**31 of them cannot overflow; each run's tail is
    read by a gather."""
    s = torch.cumsum(weights, 0, dtype=torch.int64)
    return to_i32(s[rows + runs[rows] - 1] - s[rows] + weights[rows])


def survivor_mark_weighted(keys: torch.Tensor, layout: KeyLayout,
                           n_files: int, weights: torch.Tensor):
    """krisp_tpu's ``survivor_mark_bits(..., weights=)`` over sorted keys
    int32[W, n] whose rows carry pre-collapsed counts ``weights`` (int32
    holding u32).

    ``keep`` and ``gid`` do not depend on the weights: the survivor-scan
    kernel gives them, and its run lengths at valid head rows, over which
    ``_run_sums`` sums the weights.  Returns (keep bool[n], counts int32[n]
    (u32 bit patterns, 0 off valid heads), gid int32[n])."""
    keep, runs, gid = survivor_scan_layout(keys, layout, n_files)
    heads = torch.nonzero(runs).squeeze(1)
    counts = torch.zeros_like(runs)
    counts[heads] = _run_sums(weights, runs, heads)
    return keep, counts, gid


def global_intersect_bits(words: torch.Tensor, counts: torch.Tensor,
                          layout: KeyLayout, n_files: int):
    """krisp_tpu's ``global_intersect_bits``, the global stage of the
    out-of-core path: sort, weighted survivor marking, exact compaction.

    words: int32[W, n] KeyLayout rows (genome id OR'd in; sentinel rows
    all-ones); counts: int32[n] (u32 multiplicities, 0 on sentinel rows).
    Returns (words int32[W, n_keep], counts int32[n_keep], gid
    int32[n_keep]): krisp_tpu's outputs up to ``n_keep`` (its ``cap`` and
    overflow retry are not needed)."""
    return global_intersect_rows([torch.cat([words, counts[None]])], layout,
                                 n_files)


def global_intersect_rows(table: list, layout: KeyLayout, n_files: int):
    """``global_intersect_bits`` over one int32[W + 1, n] table whose last
    row holds the counts: the counts sort as a trailing word, as
    ``sort_rows(.., order_free_payloads=True)`` sorts them, in one sort
    kernel call with V = W + 1.  ``table`` is a one-element list that the
    stage empties, so the table is freed once it is sorted.  The weighted
    counts are summed at the kept rows only: nearly every row of a
    deduplicated table heads its run, and a count for each would cost
    tens of bytes a row of device memory."""
    W = layout.n_words
    rows = sort_words(table.pop())
    keys, cnt_s = rows[:W], rows[W]
    keep, runs, gid = survivor_scan_layout(keys, layout, n_files)
    kept = torch.nonzero(keep).squeeze(1)
    return keys[:, kept], _run_sums(cnt_s, runs, kept), gid[kept]


def fused_prefilter_global(keys, left: int, mid: int, right: int, bits: int,
                           n_files: int):
    """krisp_tpu's ``fused_prefilter_global`` over per-genome key tables:
    ``global_stage`` with the prefilter on.  Returns (words, counts, gid,
    n_pre): krisp_tpu's packed rows ``[:W, :n_keep]``, ``[W, :n_keep]``,
    ``[W + 1, :n_keep]`` and ``[-1, 1]``."""
    layout = KeyLayout(left, mid, right, bits, n_files)
    return global_stage([torch.cat(list(keys), dim=1)], layout, n_files,
                        prefilter=True)
