"""Survivor scan over a sorted KeyLayout table: the CUDA kernel
``csrc/survivor_scan.cu`` and its plain PyTorch version.

Counterpart of ``krisp_tpu/ops/pallas_scan.py:pallas_survivor_scan``; the
plain version is ``krisp_tpu/ops/intersect.py:survivor_mark_bits``
(unweighted) written in torch.  Unlike the TPU kernel, any row count works,
0 included (the prefilter can keep no row).  The kernel has two modes:
``survivor_scan`` takes a validity array, ``survivor_scan_layout`` reads
validity from the genome-id field of the keys it already loads (what the
global stage runs).
"""

from __future__ import annotations

import torch

from ..convert import i32
from ..kernels import build
from .encode import KeyLayout

BIG_I32 = 2**31 - 1


def _run_heads(words: torch.Tensor) -> torch.Tensor:
    """Row i starts a run of equal rows (row 0 always does)."""
    neq = (words[:, 1:] != words[:, :-1]).any(dim=0)
    return torch.cat([neq.new_ones(1), neq])


def _masked_head(words: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Head flags for runs equal in the leading ``n_bits`` of the key."""
    full, rem = divmod(n_bits, 32)
    parts = [words[:full]]
    if rem:
        parts.append(words[full:full + 1] & i32(((1 << rem) - 1) << (32 - rem)))
    return _run_heads(torch.cat(parts))


def _reverse_cummin(x: torch.Tensor) -> torch.Tensor:
    return torch.cummin(x.flip(0), 0).values.flip(0)


def _empty_outputs(device):
    return (torch.zeros(0, dtype=torch.bool, device=device),
            torch.zeros(0, dtype=torch.int32, device=device),
            torch.zeros(0, dtype=torch.int32, device=device))


def valid_rows(keys: torch.Tensor, layout: KeyLayout) -> torch.Tensor:
    """bool[n]: the rows of int32[W, n] keys whose genome-id field is not
    the sentinel."""
    fw, fsh = layout.file_word_shift()
    field = (keys[fw] >> fsh) & layout.file_sentinel
    return field != layout.file_sentinel


def survivor_scan_reference(words: torch.Tensor, valid: torch.Tensor,
                            flank_bits: int, ff_bits: int, n_files: int):
    """Plain PyTorch version of ``survivor_scan``, on any device."""
    n = words.shape[1]
    if n == 0:
        return _empty_outputs(words.device)
    head_full = _run_heads(words)
    head_ff = _masked_head(words, ff_bits)
    head_flank = _masked_head(words, flank_bits)
    idx = torch.arange(n, dtype=torch.int64, device=words.device)
    rh = torch.where(head_full, idx, n)
    nxt = _reverse_cummin(torch.cat([rh[1:], rh.new_full((1,), n)]))
    counts = torch.where(head_full & valid, nxt - idx, 0)

    x = (head_ff & valid).to(torch.int64)
    c = torch.cumsum(x, 0)
    base = torch.cummax(torch.where(head_flank, c - x, -1), 0).values
    is_last = torch.cat([head_flank[1:], head_flank.new_ones(1)])
    endc = _reverse_cummin(torch.where(is_last, c, BIG_I32))
    survive = ((endc - base) == n_files) & valid
    gid = torch.cumsum(head_flank.to(torch.int64), 0) - 1
    return (survive & head_full, counts.to(torch.int32),
            gid.to(torch.int32))


def survivor_scan_layout_reference(words: torch.Tensor, layout: KeyLayout,
                                   n_files: int):
    """Plain PyTorch version of ``survivor_scan_layout``, on any device."""
    return survivor_scan_reference(words, valid_rows(words, layout),
                                   layout.flank_bits,
                                   layout.file_off + layout.file_bits,
                                   n_files)


def _check_words(words: torch.Tensor):
    if words.device.type != "cuda":
        raise ValueError("words must lie on a CUDA device (or the CPU)")
    if words.dtype != torch.int32 or words.dim() != 2:
        raise ValueError("words must be an int32 [W, n] tensor")
    if words.shape[1] >= BIG_I32:
        raise ValueError(f"{words.shape[1]} rows exceed the int32 row index")


def _launch(words: torch.Tensor, valid, field, flank_bits: int, ff_bits: int,
            n_files: int):
    """One call of the kernel (scan, then patch of open groups) on
    ``words``' device and current stream; ``valid`` None is layout mode
    with ``field`` = (word, shift, sentinel)."""
    W, n = words.shape
    words = words.contiguous()
    lib = build.load_library()
    dev = words.device
    nb = -(-n // lib.krisp_survivor_scan_block_rows())
    state = torch.empty(1 + 2 * nb, dtype=torch.int64, device=dev)
    open_ = torch.empty((nb, 4), dtype=torch.int32, device=dev)
    keep = torch.empty(n, dtype=torch.bool, device=dev)
    counts = torch.empty(n, dtype=torch.int32, device=dev)
    gid = torch.empty(n, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.check(lib.krisp_survivor_scan(
        dev.index, stream, words.data_ptr(), W, n,
        None if valid is None else valid.data_ptr(), *field, flank_bits,
        ff_bits, n_files, state.data_ptr(), open_.data_ptr(),
        keep.data_ptr(), counts.data_ptr(), gid.data_ptr()), "survivor_scan")
    return keep, counts, gid


def survivor_scan(words: torch.Tensor, valid: torch.Tensor, flank_bits: int,
                  ff_bits: int, n_files: int):
    """Survivor marking over sorted keys.

    words: int32[W, n] (u32 bit patterns, sorted ascending as unsigned
    tuples); valid: bool[n].  Returns (keep bool[n], counts int32[n],
    gid int32[n]): ``keep`` flags the head row of each distinct key whose
    flank group (leading ``flank_bits``) holds ``n_files`` distinct valid
    (flank, file) prefixes (leading ``ff_bits``); ``counts`` is the run
    length at valid head rows; ``gid`` numbers flank groups from 0.  A CUDA
    tensor runs the kernel (or raises); a CPU tensor runs the plain version.
    """
    if words.device.type == "cpu":
        return survivor_scan_reference(words, valid, flank_bits, ff_bits,
                                       n_files)
    _check_words(words)
    if valid.device != words.device:
        raise ValueError("words and valid must lie on one CUDA device")
    if valid.dtype != torch.bool or valid.shape != words.shape[1:]:
        raise ValueError("valid must be a bool [n] tensor")
    if words.shape[1] == 0:
        return _empty_outputs(words.device)
    out = _launch(words, valid.contiguous(), (0, 0, 0), flank_bits, ff_bits,
                  n_files)
    survivor_scan.launches += 1
    return out


def survivor_scan_layout(words: torch.Tensor, layout: KeyLayout,
                         n_files: int):
    """``survivor_scan`` with validity read from the keys: a row is valid
    where its genome-id field (``layout.file_word_shift()``) is not
    ``layout.file_sentinel``; the flank and (flank, file) prefixes are the
    layout's.  Equals ``survivor_scan(words, valid_rows(words, layout),
    ...)``; the kernel forms validity from the key words it loads anyway,
    so no validity array is made or read.  A CUDA tensor runs the kernel
    (or raises); a CPU tensor runs the plain version."""
    if words.device.type == "cpu":
        return survivor_scan_layout_reference(words, layout, n_files)
    _check_words(words)
    if words.shape[0] != layout.n_words:
        raise ValueError(f"{words.shape[0]} key words, the layout has "
                         f"{layout.n_words}")
    if words.shape[1] == 0:
        return _empty_outputs(words.device)
    fw, fsh = layout.file_word_shift()
    out = _launch(words, None, (fw, fsh, layout.file_sentinel),
                  layout.flank_bits, layout.file_off + layout.file_bits,
                  n_files)
    survivor_scan_layout.launches += 1
    return out


#: kernel launches since the last reset (CUDA calls only), by mode
survivor_scan.launches = 0
survivor_scan_layout.launches = 0
