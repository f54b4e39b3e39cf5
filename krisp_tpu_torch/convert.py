"""Key words across the numpy / torch boundary.

Key words are uint32 in krisp_tpu.  PyTorch has no shifts or scans for
unsigned 32-bit tensors on the CPU, so the port carries them as int32
tensors that hold the same bit pattern (4 bytes a word, as in JAX); the CUDA
kernels read them as ``uint32_t``.
"""

from __future__ import annotations

import numpy as np
import torch


def keys_from_numpy(u32: np.ndarray, device) -> torch.Tensor:
    """uint32 array -> int32 tensor with the same bits, on ``device`` (a
    copy: the tensor never aliases the caller's array)."""
    a = np.array(u32, dtype=np.uint32, order="C", copy=True).view(np.int32)
    return torch.from_numpy(a).to(device)


def keys_to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 bit-pattern tensor -> uint32 array."""
    return t.detach().cpu().contiguous().numpy().view(np.uint32)


def i32(u: int) -> int:
    """A Python int in [0, 2**32) as the int32 with the same bits."""
    return u - (1 << 32) if u >= 1 << 31 else u


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 tensor -> int32 tensor with the same low 32 bits."""
    return ((x << 32) >> 32).to(torch.int32)


def split_packed(packed: np.ndarray, n_words: int):
    """krisp_tpu's packed global-stage output uint32[W + 3, cap] (n_keep at
    ``[-1, 0]``, the prefilter's n_pre at ``[-1, 1]``) as the port's
    (words int32[W, n_keep], counts int32[n_keep], gid int32[n_keep]) on
    the CPU."""
    n_keep = int(packed[-1, 0])
    rows = keys_from_numpy(packed[:n_words + 2, :n_keep], "cpu")
    return rows[:n_words], rows[n_words], rows[n_words + 1]
