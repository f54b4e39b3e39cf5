"""Survivor scan over a sorted KeyLayout table: the CUDA kernel
``csrc/survivor_scan.cu`` and its plain PyTorch version.

Counterpart of ``krisp_tpu/ops/pallas_scan.py:pallas_survivor_scan``; the
plain version is ``krisp_tpu/ops/intersect.py:survivor_mark_bits``
(unweighted) written in torch.  Unlike the TPU kernel, any row count works,
0 included (the prefilter can keep no row).
"""

from __future__ import annotations

import torch

from ..convert import i32
from ..kernels import build

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
    if words.device.type != "cuda" or valid.device != words.device:
        raise ValueError("words and valid must lie on one CUDA device")
    if words.dtype != torch.int32 or words.dim() != 2:
        raise ValueError("words must be an int32 [W, n] tensor")
    if valid.dtype != torch.bool or valid.shape != words.shape[1:]:
        raise ValueError("valid must be a bool [n] tensor")
    W, n = words.shape
    if n >= BIG_I32:
        raise ValueError(f"{n} rows exceed the int32 row index")
    if n == 0:
        return _empty_outputs(words.device)
    words, valid = words.contiguous(), valid.contiguous()
    lib = build.load_library()
    dev = words.device
    nb = -(-n // lib.krisp_survivor_scan_block_rows())
    flags = torch.empty(n, dtype=torch.uint8, device=dev)
    agg = torch.empty((5, nb), dtype=torch.int32, device=dev)
    carry = torch.empty((5, nb), dtype=torch.int32, device=dev)
    keep = torch.empty(n, dtype=torch.bool, device=dev)
    counts = torch.empty(n, dtype=torch.int32, device=dev)
    gid = torch.empty(n, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.check(lib.krisp_survivor_scan(
        dev.index, stream, words.data_ptr(), W, n, valid.data_ptr(),
        flank_bits, ff_bits, n_files, flags.data_ptr(), agg.data_ptr(),
        carry.data_ptr(), keep.data_ptr(), counts.data_ptr(),
        gid.data_ptr()), "survivor_scan")
    survivor_scan.launches += 1
    return keep, counts, gid


#: kernel launches since the last reset (CUDA calls only)
survivor_scan.launches = 0
