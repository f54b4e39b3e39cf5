"""Multi-way intersection of per-genome k-mer key tables
(``krisp_tpu/ops/intersect.py``, the 2-bit spacer path).

Every genome's windows become sentinel-marked KeyLayout keys with the genome
id in the key (``extract_keys_packed_in``); the global stage concatenates
them, sorts, marks survivors (flank groups present in all genomes) and
compacts them (``fused_global_packed``).

PyTorch sizes outputs at run time, so compaction is one ``torch.nonzero``
(one host sync, exact size).  The TPU's capped two-level compaction and its
overflow retry are not needed.
"""

from __future__ import annotations

import torch

from ..convert import i32
from ..metrics import GLOBAL as METRICS
from .encode import KeyLayout
from .pack import window_keys_both
from .scan import survivor_scan
from .sort import lsd_sort

SENTINEL = -1   # the all-ones u32 word as an int32 bit pattern


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
                     mid: int, right: int, bits: int,
                     n_files: int) -> torch.Tensor:
    """Window keys of one genome buffer (uint8[P]), forward then reverse
    strand: int32[W, 2 n_win] with genome id ``file_idx`` OR'd in and
    windows that are not all A/C/G/T set to SENTINEL."""
    if bits != 2:
        raise NotImplementedError(
            "4-bit (IUPAC) keys are not ported yet (ROADMAP.md Queue 1, "
            "item 8: 4-bit keys)")
    layout = KeyLayout(left, mid, right, bits, n_files)
    fword, fshift = layout.file_word_shift()
    ok, fwd, rc = window_keys_both(buffer, left, mid, right, bits, n_files)
    words = torch.cat([fwd, rc], dim=1)
    words[fword] |= i32(file_idx << fshift)
    return torch.where(torch.cat([ok, ok]), words, SENTINEL)


def extract_keys_packed_in(packed_row: torch.Tensor, vbits_row: torch.Tensor,
                           file_idx: int, left: int, mid: int, right: int,
                           bits: int, n_files: int) -> torch.Tensor:
    """Sentinel-marked KeyLayout keys of ONE genome (both strands) with
    genome id ``file_idx`` OR'd in.

    packed_row / vbits_row: int32[1, nw] / uint8[1, nv], one genome of
    ``engine.pipeline._pack_genomes_host``.  Returns int32[W, 2 n_win].
    """
    buffer = unpack_genomes(packed_row, vbits_row)[0]
    return _all_window_keys(buffer, file_idx, left, mid, right, bits, n_files)


def compact_rows(arrays, keep: torch.Tensor):
    """The rows of each array (last axis) where ``keep`` holds, in order;
    returns (compacted arrays, n_keep)."""
    idx = torch.nonzero(keep).squeeze(1)
    return [a[..., idx] for a in arrays], idx.numel()


def valid_rows(keys: torch.Tensor, layout: KeyLayout) -> torch.Tensor:
    """bool[n]: the rows of int32[W, n] keys whose genome-id field is not
    the sentinel."""
    fw, fsh = layout.file_word_shift()
    field = (keys[fw] >> fsh) & layout.file_sentinel
    return field != layout.file_sentinel


def _global_tail(flat: torch.Tensor, layout: KeyLayout, n_files: int):
    """Sort -> survivor scan -> compaction over sentinel-marked keys
    int32[W, n].  Returns (words int32[W, n_keep], counts int32[n_keep],
    gid int32[n_keep])."""
    dev = flat.device
    with METRICS.stage("sort", items=flat.shape[1], device=dev):
        keys = torch.stack(lsd_sort(list(flat))[0])
    with METRICS.stage("scan", device=dev):
        keep, counts, gid = survivor_scan(
            keys, valid_rows(keys, layout), layout.flank_bits,
            layout.file_off + layout.file_bits, n_files)
    with METRICS.stage("compact", device=dev):
        (words, counts, gid), _ = compact_rows([keys, counts, gid], keep)
    return words, counts, gid


def fused_global_packed(keys, left: int, mid: int, right: int, bits: int,
                        n_files: int):
    """Global stage over per-genome ``extract_keys_packed_in`` outputs:
    concatenate, sort, mark survivors, compact.  Returns (words int32[W,
    n_keep], counts int32[n_keep], gid int32[n_keep]) in sorted-key order —
    krisp_tpu's packed rows ``[:W, :n_keep]``, ``[W, :n_keep]`` and
    ``[W + 1, :n_keep]``."""
    layout = KeyLayout(left, mid, right, bits, n_files)
    return _global_tail(torch.cat(list(keys), dim=1), layout, n_files)
