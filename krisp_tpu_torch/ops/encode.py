"""Key plan and plain PyTorch window-key packing.

``KeyLayout``, ``_word_runs`` and ``sort_perm`` are copies of the JAX-free
helpers in ``krisp_tpu/ops/encode.py`` (pinned equal by
tests/test_torch_encode.py).  ``pack_both_strands`` is the plain version of
the 2-bit window-key kernel: log-tree packing as in krisp_tpu's
``window_keys_tree``.  ``window_keys_bits`` packs keys of any width base by
base; krisp_tpu has no Pallas kernel for the 4-bit (IUPAC) keys it serves,
so these torch ops are their port.  Packing runs in int64 so every shift is
defined, and the words come back as int32 bit patterns.
"""

from __future__ import annotations

import collections

import torch

from ..convert import to_i32


def sort_perm(left: int, mid: int, right: int) -> tuple[int, ...]:
    """Base-index permutation implementing the [left|right|mid] key layout."""
    L = left + mid + right
    return tuple(range(left)) + tuple(range(left + mid, L)) + tuple(range(left, left + mid))


class KeyLayout:
    """Bit-level plan for the packed [flank | genome-id | mid] sort key.

    Every row's entire identity — flank pair, source genome, and mid
    sequence — lives in one minimal multi-word integer key, so the global
    (flank, genome, mid) order needs ONLY key words as sort operands: the
    fewest possible LSD passes with nothing carried.  The genome-id field
    doubles as the validity marker (all-ones = sentinel), which also makes
    sentinel rows unambiguous for every geometry.

    Field placement never straddles a word: the genome field is padded to
    fit inside one word, and base fields are bits-aligned by construction
    (32 % bits == 0).
    """

    def __init__(self, left: int, mid: int, right: int, bits: int,
                 n_files: int):
        self.left, self.mid, self.right, self.bits = left, mid, right, bits
        self.flank_bits = (left + right) * bits
        fb = max(bits, (max(n_files, 1)).bit_length())  # sentinel > any id
        fb = -(-fb // bits) * bits                      # bits-aligned
        self.file_bits = fb
        fo = self.flank_bits
        if fo % 32 + fb > 32:
            fo = (fo // 32 + 1) * 32
        self.file_off = fo
        self.mid_off = fo + fb
        self.total_bits = self.mid_off + mid * bits
        self.n_words = -(-self.total_bits // 32)
        self.file_sentinel = (1 << fb) - 1

    def base_offsets(self):
        """(flank base bit-offsets, mid base bit-offsets) in layout order:
        left bases, right bases | mid bases."""
        b = self.bits
        flank = [i * b for i in range(self.left + self.right)]
        mid = [self.mid_off + i * b for i in range(self.mid)]
        return flank, mid

    def file_word_shift(self):
        w = self.file_off // 32
        sh = 32 - (self.file_off % 32) - self.file_bits
        return w, sh

    def _key(self):
        return (self.left, self.mid, self.right, self.bits, self.file_bits)

    def __hash__(self):
        return hash(self._key())

    def __eq__(self, other):
        return (isinstance(other, KeyLayout)
                and self._key() == other._key())


def _word_runs(perm, offs, bits: int):
    """Group a word's base slots into maximal contiguous runs.

    Returns {word: [(p0, bit0, m)]}: m bases starting at window position
    p0, landing at bit offset bit0 within the word, with window position
    and bit offset advancing in lockstep — the unit the tree composition
    packs with one slice per binary-decomposition part."""
    runs = collections.defaultdict(list)
    cur = None  # (word, p0, bit0, m)
    for off, p in sorted(zip(offs, perm)):
        w, b = off // 32, off % 32
        if (cur is not None and cur[0] == w and p == cur[1] + cur[3]
                and b == cur[2] + bits * cur[3]):
            cur = (w, cur[1], cur[2], cur[3] + 1)
        else:
            if cur is not None:
                runs[cur[0]].append(cur[1:])
            cur = (w, p, b, 1)
    if cur is not None:
        runs[cur[0]].append(cur[1:])
    return runs


def layout_runs(layout: KeyLayout):
    """``_word_runs`` of a layout's [left|right] flank and mid slots."""
    left, mid, right = layout.left, layout.mid, layout.right
    L = left + mid + right
    perm = (tuple(range(left)) + tuple(range(left + mid, L))
            + tuple(range(left, left + mid)))
    off_flank, off_mid = layout.base_offsets()
    return _word_runs(perm, tuple(off_flank) + tuple(off_mid), layout.bits)


def encode_ascii(ascii_u8: torch.Tensor, code_table, valid_table):
    """ASCII uint8[P] -> (codes int64[P], valid bool[P]) through the
    per-byte tables; invalid bases get code 0."""
    dev = ascii_u8.device
    idx = ascii_u8.to(torch.int64)
    codes = torch.as_tensor(code_table, device=dev).to(torch.int64)[idx]
    valid = torch.as_tensor(valid_table, device=dev)[idx]
    return torch.where(valid, codes, 0), valid


def window_validity(valid: torch.Tensor, L: int) -> torch.Tensor:
    """valid[i] per base -> ok[i] per window start (all L bases valid)."""
    bad = (~valid).to(torch.int64)
    csum = torch.cat([bad.new_zeros(1), torch.cumsum(bad, 0)])
    return (csum[L:] - csum[:csum.numel() - L]) == 0


def _ladder(first: torch.Tensor, combine, top: int):
    """Doubling chunk ladder: arrs[a][i] covers the ``a`` bases from i,
    for a = 1, 2, 4, ... up to ``top``."""
    arrs = {1: first}
    a = 1
    while 2 * a <= top:
        prev = arrs[a]
        arrs[2 * a] = combine(prev[:prev.numel() - a], prev[a:], a)
        a *= 2
    return arrs


def _compose(arrs, start_of, bit0: int, m: int, n_win: int):
    """One run's bits: the binary decomposition of ``m`` bases into ladder
    chunks, the chunk of ``a`` bases after ``consumed`` read at
    ``start_of(consumed, a)``."""
    acc, consumed, a = None, 0, 16
    while consumed < m:
        if a <= m - consumed:
            s = start_of(consumed, a)
            part = arrs[a][s:s + n_win] << (32 - bit0 - 2 * (consumed + a))
            acc = part if acc is None else acc | part
            consumed += a
        else:
            a //= 2
    return acc


def pack_both_strands(codes: torch.Tensor, comp_codes: torch.Tensor,
                      valid: torch.Tensor, layout: KeyLayout):
    """Window keys of both strands from per-base 2-bit codes.

    codes / comp_codes: integer [P] (a base's code and its complement's);
    valid: bool [P].  Returns (ok bool[n_win], fwd int32[W, n_win],
    rc int32[W, n_win]) with n_win = P - L + 1 and the genome-id field zero.
    """
    L = layout.left + layout.mid + layout.right
    n_win = codes.numel() - L + 1
    ok = window_validity(valid, L)
    runs = layout_runs(layout)
    max_m = max((r[2] for rs in runs.values() for r in rs), default=1)
    top = 1
    while 2 * top <= min(max_m, 16):
        top *= 2
    fwd_arrs = _ladder(codes.to(torch.int64),
                       lambda lo, hi, a: (lo << (2 * a)) | hi, top)
    # rc_a(i): reverse complement of bases [i, i + a)
    rc_arrs = _ladder(comp_codes.to(torch.int64),
                      lambda lo, hi, a: (hi << (2 * a)) | lo, top)

    def build(arrs, start_of):
        words = []
        for w in range(layout.n_words):
            acc = torch.zeros(n_win, dtype=torch.int64, device=codes.device)
            for p0, bit0, m in runs.get(w, []):
                acc = acc | _compose(arrs, lambda c, a: start_of(p0, c, a),
                                     bit0, m, n_win)
            words.append(to_i32(acc))
        return torch.stack(words)

    # key slots p0.. of the rc key hold sources L-1-p0 descending: the
    # revcomp chunk of source span [L-p0-c-a, L-p0-c)
    fwd = build(fwd_arrs, lambda p0, c, a: p0 + c)
    rc = build(rc_arrs, lambda p0, c, a: L - p0 - c - a)
    return ok, fwd, rc


def window_keys_tree(ascii_u8: torch.Tensor, code_table, valid_table,
                     comp_table, left: int, mid: int, right: int,
                     n_files: int):
    """krisp_tpu's ``window_keys_tree`` (2-bit, table-driven encode):
    returns (ok bool[2 n_win], words list of W int32[2 n_win]), forward rows
    first, then reverse complements; the genome-id field is zero."""
    codes, valid = encode_ascii(ascii_u8, code_table, valid_table)
    comp = torch.as_tensor(comp_table, device=codes.device).to(
        torch.int64)[codes]
    layout = KeyLayout(left, mid, right, 2, n_files)
    ok, fwd, rc = pack_both_strands(codes, comp, valid, layout)
    words = torch.cat([fwd, rc], dim=1)
    return torch.cat([ok, ok]), list(words)


def pack_windows_at(codes: torch.Tensor, perm, offsets, bits: int,
                    n_win: int, n_words: int):
    """Pack window bases into key words at explicit bit offsets.

    codes: int64[N]; perm: base index within the window per field slot;
    offsets: absolute bit offset per slot.  Returns n_words int32[n_win]."""
    per_word = collections.defaultdict(list)
    for p, off in zip(perm, offsets):
        per_word[off // 32].append((p, off % 32))
    words = []
    for w in range(n_words):
        acc = torch.zeros(n_win, dtype=torch.int64, device=codes.device)
        for p, bit in per_word.get(w, []):
            acc |= codes[p:p + n_win] << (32 - bit - bits)
        words.append(to_i32(acc))
    return words


def window_keys_bits(ascii_u8: torch.Tensor, code_table, valid_table,
                     comp_table, left: int, mid: int, right: int, bits: int,
                     n_files: int):
    """krisp_tpu's ``window_keys_bits``: window keys straight into the
    bit-packed KeyLayout, base by base, for any ``bits``.

    Returns (ok bool[2 n_win], words list of W int32[2 n_win]), forward rows
    first, then reverse complements; the genome-id field is zero."""
    L = left + mid + right
    layout = KeyLayout(left, mid, right, bits, n_files)
    codes, valid = encode_ascii(ascii_u8, code_table, valid_table)
    ok = window_validity(valid, L)
    n_win = ok.numel()
    perm = sort_perm(left, mid, right)
    off_flank, off_mid = layout.base_offsets()
    offs = off_flank + off_mid
    comp = torch.as_tensor(comp_table, device=codes.device).to(
        torch.int64)[codes]
    fwd = pack_windows_at(codes, perm, offs, bits, n_win, layout.n_words)
    rc = pack_windows_at(comp, tuple(L - 1 - p for p in perm), offs, bits,
                         n_win, layout.n_words)
    words = [torch.cat([a, b]) for a, b in zip(fwd, rc)]
    return torch.cat([ok, ok]), words
