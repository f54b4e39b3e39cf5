"""Merge of two sorted multi-word tables: the CUDA kernel
``csrc/merge_words.cu`` and its plain PyTorch version.

Counterpart of ``krisp_tpu/ops/pallas_merge.py:merge_sorted_words``, with
its contract: two int32[V, n] tables of u32 bit patterns, each sorted
ascending as unsigned tuples, become one sorted int32[V, nA + nB] table.
Equal rows are identical, so their order does not show.  Any row count
works, empty runs included.
"""

from __future__ import annotations

import torch

from ..kernels import build
from .sort import sort_words_reference


def merge_sorted_words_reference(A: torch.Tensor,
                                 B: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``merge_sorted_words``, on any device: the
    sort of both tables' rows, which by the contract is their merge."""
    return sort_words_reference(torch.cat([A, B], dim=1))


def merge_sorted_words(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Rows of the sorted int32[V, nA] ``A`` and int32[V, nB] ``B`` merged
    into one int32[V, nA + nB] table in ascending unsigned lexicographic
    order (all-ones rows are plain keys).  CUDA tensors run the kernel (or
    raise); CPU tensors run the plain version."""
    if A.device.type == "cpu" and B.device.type == "cpu":
        return merge_sorted_words_reference(A, B)
    if A.device.type != "cuda" or B.device != A.device:
        raise ValueError("A and B must lie on one CUDA device")
    if (A.dtype != torch.int32 or B.dtype != torch.int32 or A.dim() != 2
            or B.dim() != 2 or A.shape[0] != B.shape[0]):
        raise ValueError("A and B must be int32 [V, n] tensors of one V")
    V, na = A.shape
    nb = B.shape[1]
    n = na + nb
    if n >= 2**31:
        raise ValueError(f"{n} rows exceed the kernel's 32-bit row ids")
    out = torch.empty((V, n), dtype=torch.int32, device=A.device)
    if n == 0:
        return out
    lib = build.load_library()
    if not 1 <= V <= lib.krisp_merge_words_max_words():
        raise ValueError(f"{V} words per row; the kernel takes 1 to "
                         f"{lib.krisp_merge_words_max_words()}")
    A, B = A.contiguous(), B.contiguous()
    dev = A.device
    tile = lib.krisp_merge_words_tile_rows(V)
    splits = torch.empty(-(-n // tile) + 1, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.check(lib.krisp_merge_words(
        dev.index, stream, A.data_ptr(), na, B.data_ptr(), nb, V,
        out.data_ptr(), splits.data_ptr()), "merge_sorted_words")
    merge_sorted_words.launches += 1
    return out


#: kernel launches since the last reset (CUDA calls only)
merge_sorted_words.launches = 0
