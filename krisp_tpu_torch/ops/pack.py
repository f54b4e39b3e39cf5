"""Window keys of one genome buffer, both strands: the CUDA kernel
``csrc/window_keys.cu`` and its plain PyTorch versions, in two modes.

``window_keys_both`` is the counterpart of
``krisp_tpu/ops/pallas_pack.py:pallas_window_keys_both``.  The port returns
exactly ``n_win = P - L + 1`` windows (no TPU tile padding).  ``ok`` is
exact at every window; the words are exact where ``ok`` holds.

``window_keys_table`` is the 2-bit branch of krisp_tpu's per-genome table
(``ops/intersect.py:_all_window_keys``) in one kernel launch: the keys of
both strands with the genome id OR'd in and SENTINEL rows at windows that
are not valid, written straight into a slice of the caller's table.
"""

from __future__ import annotations

import functools

import torch

from ..convert import i32
from ..kernels import build
from .encode import KeyLayout, layout_runs, pack_both_strands

SENTINEL = -1   # the all-ones u32 word as an int32 bit pattern


def _codes_and_valid(buffer: torch.Tensor, omit_soft: bool):
    """uint8 ASCII -> (2-bit code, validity), arithmetic only, as
    ``pallas_pack._codes_and_valid``: y = (upper >> 1) & 3 gives A0 C1 T2
    G3, and y ^ (y >> 1) swaps 2 and 3."""
    b = buffer.to(torch.int32)
    upper = b & 0xDF
    y = (upper >> 1) & 3
    code = y ^ (y >> 1)
    valid = (upper == 65) | (upper == 67) | (upper == 71) | (upper == 84)
    if omit_soft:
        valid = valid & ((b & 0x20) == 0)
    return code, valid


def window_keys_both_reference(buffer: torch.Tensor, left: int, mid: int,
                               right: int, bits: int, n_files: int,
                               omit_soft: bool = False):
    """Plain PyTorch version of ``window_keys_both``, on any device."""
    if bits != 2:
        raise NotImplementedError("window keys cover the 2-bit encoding only")
    layout = KeyLayout(left, mid, right, bits, n_files)
    if buffer.numel() < left + mid + right:   # no window, as the kernel
        empty = torch.empty((layout.n_words, 0), dtype=torch.int32,
                            device=buffer.device)
        return (torch.empty(0, dtype=torch.bool, device=buffer.device),
                empty, empty.clone())
    code, valid = _codes_and_valid(buffer, omit_soft)
    return pack_both_strands(code, 3 - code, valid, layout)


@functools.cache
def _run_table(layout: KeyLayout, device: torch.device) -> torch.Tensor:
    """The key plan as (word, p0, bit0, m) rows, sorted by word: built and
    uploaded once per layout and device, not on every launch."""
    rows = [(w, p0, bit0, m) for w, rs in sorted(layout_runs(layout).items())
            for p0, bit0, m in rs]
    return torch.tensor(rows, dtype=torch.int32, device=device).reshape(-1, 4)


def _kernel_args(buffer: torch.Tensor, left: int, mid: int, right: int,
                 bits: int, n_files: int):
    """Checks a CUDA call; returns (lib, buffer, layout, runs)."""
    if buffer.device.type != "cuda":
        raise ValueError(f"unsupported device {buffer.device}")
    if bits != 2:
        raise NotImplementedError("window keys cover the 2-bit encoding only")
    if buffer.dtype != torch.uint8 or buffer.dim() != 1:
        raise ValueError("buffer must be a 1-D uint8 tensor")
    lib = build.load_library()
    L = left + mid + right
    if L > lib.krisp_window_keys_max_len():
        raise ValueError(f"window length {L} exceeds the kernel's "
                         f"{lib.krisp_window_keys_max_len()}")
    layout = KeyLayout(left, mid, right, bits, n_files)
    runs = _run_table(layout, buffer.device)
    if runs.shape[0] > lib.krisp_window_keys_max_runs():
        raise ValueError(f"{runs.shape[0]} key runs exceed the kernel's "
                         f"{lib.krisp_window_keys_max_runs()}")
    return lib, buffer.contiguous(), layout, runs


def window_keys_both(buffer: torch.Tensor, left: int, mid: int, right: int,
                     bits: int, n_files: int, omit_soft: bool = False):
    """Window keys of both strands of one genome buffer.

    buffer: uint8[P].  Returns (ok bool[n_win], fwd int32[W, n_win],
    rc int32[W, n_win]): the forward and reverse-complement KeyLayout words
    as u32 bit patterns, genome-id field zero.  A CUDA tensor runs the
    kernel (or raises); a CPU tensor runs the plain version.
    """
    if buffer.device.type == "cpu":
        return window_keys_both_reference(buffer, left, mid, right, bits,
                                          n_files, omit_soft)
    lib, buffer, layout, runs = _kernel_args(buffer, left, mid, right, bits,
                                             n_files)
    P, W, L = buffer.numel(), layout.n_words, left + mid + right
    n_win = max(P - L + 1, 0)
    ok = torch.empty(n_win, dtype=torch.bool, device=buffer.device)
    fwd = torch.empty((W, n_win), dtype=torch.int32, device=buffer.device)
    rc = torch.empty((W, n_win), dtype=torch.int32, device=buffer.device)
    stream = torch.cuda.current_stream(buffer.device).cuda_stream
    build.check(lib.krisp_window_keys(
        buffer.device.index, stream, buffer.data_ptr(), P, L, W,
        runs.data_ptr(), runs.shape[0], int(omit_soft), ok.data_ptr(),
        fwd.data_ptr(), rc.data_ptr()), "window_keys")
    window_keys_both.launches += 1
    return ok, fwd, rc


#: kernel launches since the last reset (CUDA calls only)
window_keys_both.launches = 0


def _table_out(out, W: int, n_win: int, device) -> torch.Tensor:
    if out is None:
        return torch.empty((W, 2 * n_win), dtype=torch.int32, device=device)
    if (out.dtype != torch.int32 or out.shape != (W, 2 * n_win)
            or out.device != device or (n_win and out.stride(1) != 1)):
        raise ValueError(f"out must be int32[{W}, {2 * n_win}] on {device} "
                         "with unit column stride")
    return out


def window_keys_table_reference(buffer: torch.Tensor, file_idx: int,
                                left: int, mid: int, right: int,
                                n_files: int, omit_soft: bool = False,
                                out: torch.Tensor | None = None):
    """Plain PyTorch version of ``window_keys_table``: the torch ops of
    krisp_tpu's ``_all_window_keys`` 2-bit branch over the plain window
    keys."""
    layout = KeyLayout(left, mid, right, 2, n_files)
    fword, fshift = layout.file_word_shift()
    ok, fwd, rc = window_keys_both_reference(buffer, left, mid, right, 2,
                                             n_files, omit_soft)
    ok, words = torch.cat([ok, ok]), torch.cat([fwd, rc], dim=1)
    words[fword] |= i32(file_idx << fshift)
    words = torch.where(ok, words, SENTINEL)
    if out is None:
        return words
    _table_out(out, layout.n_words, fwd.shape[1], buffer.device).copy_(words)
    return out


def window_keys_table(buffer: torch.Tensor, file_idx: int, left: int,
                      mid: int, right: int, n_files: int,
                      omit_soft: bool = False,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """2-bit keys of one genome buffer (uint8[P]), forward then reverse
    strand: int32[W, 2 n_win] with genome id ``file_idx`` OR'd in and
    windows that are not all valid bases set to SENTINEL.

    ``out``, when given, receives the table (any int32[W, 2 n_win] view with
    unit column stride, such as a column slice of a wider table) and is
    returned.  A CUDA tensor runs the kernel (or raises); a CPU tensor runs
    the plain version."""
    if buffer.device.type == "cpu":
        return window_keys_table_reference(buffer, file_idx, left, mid,
                                           right, n_files, omit_soft, out)
    lib, buffer, layout, runs = _kernel_args(buffer, left, mid, right, 2,
                                             n_files)
    P, W, L = buffer.numel(), layout.n_words, left + mid + right
    n_win = max(P - L + 1, 0)
    out = _table_out(out, W, n_win, buffer.device)
    fword, fshift = layout.file_word_shift()
    stream = torch.cuda.current_stream(buffer.device).cuda_stream
    build.check(lib.krisp_window_keys_table(
        buffer.device.index, stream, buffer.data_ptr(), P, L, W,
        runs.data_ptr(), runs.shape[0], int(omit_soft), out.data_ptr(),
        out.stride(0), fword, (file_idx << fshift) & 0xFFFFFFFF),
        "window_keys_table")
    window_keys_table.launches += 1
    return out


#: kernel launches since the last reset (CUDA calls only)
window_keys_table.launches = 0
