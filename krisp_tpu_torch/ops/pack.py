"""Window keys of one genome buffer, both strands: the CUDA kernel
``csrc/window_keys.cu`` and its plain PyTorch version.

Counterpart of ``krisp_tpu/ops/pallas_pack.py:pallas_window_keys_both``.
The port returns exactly ``n_win = P - L + 1`` windows (no TPU tile
padding).  ``ok`` is exact at every window; the words are exact where ``ok``
holds.
"""

from __future__ import annotations

import torch

from ..kernels import build
from .encode import KeyLayout, layout_runs, pack_both_strands


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
    code, valid = _codes_and_valid(buffer, omit_soft)
    return pack_both_strands(code, 3 - code, valid,
                             KeyLayout(left, mid, right, bits, n_files))


def _run_table(layout: KeyLayout, device) -> torch.Tensor:
    """The key plan as (word, p0, bit0, m) rows, sorted by word."""
    rows = [(w, p0, bit0, m) for w, rs in sorted(layout_runs(layout).items())
            for p0, bit0, m in rs]
    return torch.tensor(rows, dtype=torch.int32, device=device).reshape(-1, 4)


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
    if buffer.device.type != "cuda":
        raise ValueError(f"unsupported device {buffer.device}")
    if bits != 2:
        raise NotImplementedError("window keys cover the 2-bit encoding only")
    if buffer.dtype != torch.uint8 or buffer.dim() != 1:
        raise ValueError("buffer must be a 1-D uint8 tensor")
    buffer = buffer.contiguous()
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
    P, W = buffer.numel(), layout.n_words
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
