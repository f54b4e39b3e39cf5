"""Lexicographic sort of multi-word u32 keys (``krisp_tpu/ops/sort.py``):
the CUDA radix sort ``csrc/sort_words.cu`` and its plain PyTorch version.

Key words are int32 tensors holding u32 bit patterns, most significant
first.  ``sort_words`` is the row sort of every device path; on a CUDA
tensor it launches the kernel (the counterpart of
``krisp_tpu/ops/pallas_sort.py:bitonic_sort_words``).  ``sort_rows`` keeps
krisp_tpu's signature over it, for the differential tests.  The TPU's
backend switch is not carried over: on the card the kernel *is*
``sort_rows``' backend.

``varying_masks`` and ``sort_pass_plan`` are the kernel's plan of passes:
which key bits each pass's digit takes, from what varies across the rows.

``lsd_sort`` is the plain version: adjacent words fuse into one int64 digit
whose signed order equals the unsigned order of the word pair (the high
word is biased by 2**31), so a 60-bit spacer key sorts in one
``torch.sort``; wider keys sort by least-significant-digit passes of stable
sorts.  It also serves ``sort_rows`` calls that carry ordered payloads.
"""

from __future__ import annotations

import ctypes

import torch

from ..convert import to_i32
from ..kernels import build

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


def sort_words_reference(stacked: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``sort_words``: ``lsd_sort`` over the rows."""
    return torch.stack(lsd_sort(list(stacked))[0])


#: the widest digit a sort pass takes, in bits: the kernel's kMaxBits (512
#: bins).  Wider digits save passes but cost more a pass on the H100 (see
#: PERF.md)
DIGIT_BITS = 9
#: the widest rows whose passes carry the key words themselves (key mode);
#: wider rows sort (word, row id) pairs word by word (index mode), as the
#: kernel's krisp_sort_words_key_mode_words says
KEY_MODE_WORDS = 3


def varying_masks(ones, zeros, flags):
    """Per word (word 0 most significant) the key bits that the passes
    must cover, from the kernel's fold of the rows that are not all ones:
    ``ones[v]`` and ``zeros[v]`` OR word v and its complement over those
    rows, ``flags`` has bit 0 set if a row is all ones (a sentinel) and
    bit 1 if a row is not.

    The bits set in both vary across the non-sentinel rows.  Sentinels
    add one bit, not all: the highest bit that is 0 in every other row.
    A row's first bit (from the top) that differs from a sentinel is its
    highest 0 bit, which is either a varying bit or that one, so passes
    over these bits put every sentinel after every other row.  All rows
    sentinels, or all equal: no bit."""
    if not flags & 2:
        return [0] * len(ones)
    masks = [o & z for o, z in zip(ones, zeros)]
    if flags & 1:
        for v, o in enumerate(ones):
            if o != 0xFFFFFFFF:
                masks[v] |= 1 << ((~o & 0xFFFFFFFF).bit_length() - 1)
                break
    return masks


def sort_pass_plan(masks):
    """The passes of the sort kernel: [(lo, width)], least significant
    first, each digit the key bits [lo, lo + width).

    ``masks``: per word (word 0 most significant) the bits to cover
    (``varying_masks``); bit b of the key is bit b % 32 of word
    V - 1 - b // 32.  The digits cover every such bit: the fewest passes
    that digits of ``DIGIT_BITS`` bits allow (a greedy cover from the
    lowest bit is the least), each as narrow as that count of passes
    allows (fewer bins), and each ending at the highest bit it covers.  No
    bit: no pass.  Above ``KEY_MODE_WORDS`` words (the kernel's index
    mode) each word is covered on its own, so that no digit spans two
    words."""
    V = len(masks)
    if V > KEY_MODE_WORDS:
        return [(lo + 32 * (V - 1 - v), width)
                for v in reversed(range(V))
                for lo, width in sort_pass_plan([masks[v]])]
    key = 0
    for m in masks:
        key = key << 32 | (int(m) & 0xFFFFFFFF)

    def cover(width):
        plan, rest = [], key
        while rest:
            lo = (rest & -rest).bit_length() - 1
            hi = (rest & (((1 << width) - 1) << lo)).bit_length()
            plan.append((lo, hi - lo))
            rest &= -1 << (lo + width)
        return plan

    n_passes = len(cover(DIGIT_BITS))
    return next(p for w in range(-(-key.bit_count() // n_passes) if key
                                 else 1, DIGIT_BITS + 1)
                if len(p := cover(w)) == n_passes)


def sort_words(stacked: torch.Tensor) -> torch.Tensor:
    """Rows of int32[V, n] (u32 bit patterns, word 0 most significant) in
    ascending unsigned lexicographic order; all-ones sentinel rows last.

    Stability is not promised (``bitonic_sort_words``' contract); equal rows
    are identical, so the result is exact either way.  A CUDA tensor runs
    the kernel (or raises); a CPU tensor runs the plain version.
    """
    if stacked.device.type == "cpu":
        return sort_words_reference(stacked)
    if stacked.device.type != "cuda":
        raise ValueError(f"unsupported device {stacked.device}")
    if stacked.dtype != torch.int32 or stacked.dim() != 2:
        raise ValueError("stacked must be an int32 [V, n] tensor")
    V, n = stacked.shape
    if n >= 2**31:
        raise ValueError(f"{n} rows exceed the kernel's 32-bit row ids")
    out = torch.empty_like(stacked, memory_format=torch.contiguous_format)
    if n == 0:
        return out
    lib = build.load_library()
    if not 1 <= V <= lib.krisp_sort_words_max_words():
        raise ValueError(f"{V} words per row; the kernel takes 1 to "
                         f"{lib.krisp_sort_words_max_words()}")
    if (lib.krisp_sort_words_key_mode_words() != KEY_MODE_WORDS
            or lib.krisp_sort_words_max_bits() != DIGIT_BITS):
        raise RuntimeError("the sort kernel's key-mode width or digit cap "
                           "differs from KEY_MODE_WORDS or DIGIT_BITS")
    stacked = stacked.contiguous()
    dev = stacked.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    acc = torch.empty(2 * V + 1, dtype=torch.int32, device=dev)
    # buffers for any plan, allocated before the readback so that the
    # card waits for no more host work after it than the plan itself
    scratch = torch.empty(V * n if V <= KEY_MODE_WORDS else 6 * n,
                          dtype=torch.int32, device=dev)
    status = torch.empty(lib.krisp_sort_words_status_words(n),
                         dtype=torch.int32, device=dev)
    build.check(lib.krisp_sort_words_vary(dev.index, stream,
                                          stacked.data_ptr(), V, n,
                                          acc.data_ptr()), "sort_words")
    # the call's one readback: the host queues one kernel per pass, and the
    # number of passes (so also which buffer each pass writes, for the last
    # to land in ``out``) follows from the bits that vary
    acc = [a & 0xFFFFFFFF for a in acc.tolist()]
    plan = sort_pass_plan(varying_masks(acc[:V], acc[V:2 * V], acc[2 * V]))
    flat = [x for pass_ in plan for x in pass_]
    hist = torch.empty(len(plan) << DIGIT_BITS, dtype=torch.int32,
                       device=dev)
    build.check(lib.krisp_sort_words(
        dev.index, stream, stacked.data_ptr(), V, n,
        (ctypes.c_int * len(flat))(*flat), len(plan), out.data_ptr(),
        scratch.data_ptr(), hist.data_ptr(), status.data_ptr()),
        "sort_words")
    sort_words.launches += 1
    return out


#: kernel launches since the last reset (CUDA calls only)
sort_words.launches = 0


def sort_rows(words, payloads=(), order_free_payloads=False):
    """Lexicographic sort of multi-word rows (``krisp_tpu``'s
    ``sort_rows``).

    Semantics equal ``lsd_sort`` (stable) except that when
    ``order_free_payloads`` is set the caller asserts payload order within
    equal-key runs is immaterial, so the payloads sort as trailing words.
    Returns (keys_sorted list, payloads_sorted list).  The pipeline sorts a
    stacked [W, n] table with ``sort_words`` directly; this list signature
    and the payload branches are krisp_tpu's, kept so the differential
    tests hold the two packages to one contract.
    """
    words, payloads = list(words), list(payloads)
    if payloads and not order_free_payloads:
        return lsd_sort(words, payloads)
    out = sort_words(torch.stack(words + payloads))
    return list(out[:len(words)]), list(out[len(words):])


def sort_with_rowid(key_word: torch.Tensor):
    """Stable sort of one u32 key word: (key_sorted int32, row ids int64).

    The key biased by 2**31 sorts as a signed int32 in the unsigned order
    of the word; a stable ``torch.sort`` returns the row ids as its indices
    (krisp_tpu uses ``jax.lax.sort`` here too, not a Pallas kernel)."""
    out = torch.sort(key_word ^ _BIAS, stable=True)
    return out.values ^ _BIAS, out.indices
