"""DNA alphabet tables and host-side encode/decode helpers.

Feature parity notes (reference: grunwaldlab/krisp):
  - Complement map incl. IUPAC codes: reference src/krisp/kstream/kstream.py:11-18
  - IUPAC expansion table: kstream.py:21-42
  - IUPAC consensus collapse: krisp_fasta/Amplicon.py:42-66 (built there from
    Bio.Data.IUPACData; re-derived here from first principles since the table
    is a fixed standard).

TPU-native design: bases are encoded as small integers whose numeric order
equals the ASCII byte order of the uppercase letters.  Packed keys compared as
unsigned integers therefore reproduce ``LC_ALL=C sort`` exactly, which is the
collation the reference relies on for its sorted k-mer tables.
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Alphabets
# ---------------------------------------------------------------------------

#: Uppercase IUPAC nucleotide letters in ASCII order (rank == 4-bit code).
IUPAC_LETTERS = "ABCDGHKMNRSTVWY"  # 15 letters; code 15 is reserved/padding

#: The unambiguous alphabet in ASCII order (rank == 2-bit code).
ACGT = "ACGT"

#: Watson-Crick complement for every supported letter (upper & lower case).
COMPLEMENT = {
    "A": "T", "T": "A", "G": "C", "C": "G",
    "R": "Y", "Y": "R", "M": "K", "K": "M",
    "S": "S", "W": "W", "B": "V", "V": "B",
    "D": "H", "H": "D", "N": "N",
}
COMPLEMENT.update({k.lower(): v.lower() for k, v in list(COMPLEMENT.items())})

#: IUPAC ambiguity code -> tuple of concrete bases (uppercase & lowercase).
IUPAC_EXPAND = {
    "R": ("A", "G"), "Y": ("C", "T"), "S": ("G", "C"), "W": ("A", "T"),
    "K": ("G", "T"), "M": ("A", "C"), "B": ("C", "G", "T"),
    "D": ("A", "G", "T"), "H": ("A", "C", "T"), "V": ("A", "C", "G"),
    "N": ("A", "C", "G", "T"),
}
IUPAC_EXPAND.update(
    {k.lower(): tuple(b.lower() for b in v) for k, v in list(IUPAC_EXPAND.items())}
)

#: sorted tuple of concrete upper-case bases -> IUPAC consensus letter.
IUPAC_COLLAPSE = {
    ("A",): "A", ("C",): "C", ("G",): "G", ("T",): "T",
    ("A", "C"): "M", ("A", "G"): "R", ("A", "T"): "W",
    ("C", "G"): "S", ("C", "T"): "Y", ("G", "T"): "K",
    ("A", "C", "G"): "V", ("A", "C", "T"): "H",
    ("A", "G", "T"): "D", ("C", "G", "T"): "B",
    ("A", "C", "G", "T"): "N",
}


def collapse_to_iupac(seqs):
    """Consensus of equal-length sequences via IUPAC ambiguity codes.

    Behaviour parity: Amplicon.py:42-66 / krisp_vcf.py:116-140 — unequal
    lengths collapse to ``'-' * max_len``; any column containing ``*``, ``N``
    or ``?`` becomes ``N``.
    """
    seqs = list(seqs)
    lens = {len(s) for s in seqs}
    max_len = max(lens)
    if len(lens) != 1:
        return "-" * max_len
    out = []
    for i in range(max_len):
        col = {s[i] for s in seqs}
        if "*" in col or "N" in col or "?" in col:
            out.append("N")
        else:
            key = tuple(sorted(col))
            if key in IUPAC_COLLAPSE:
                out.append(IUPAC_COLLAPSE[key])
            else:
                raise KeyError(f"cannot collapse column {key!r}")
    return "".join(out)


def revcomp(seq: str) -> str:
    """Reverse complement of a string sequence (host-side)."""
    return "".join(COMPLEMENT[b] for b in reversed(seq))


# ---------------------------------------------------------------------------
# Integer encodings (host numpy tables; consumed by device kernels via take)
# ---------------------------------------------------------------------------

def _build_tables():
    # 2-bit: only A C G T (uppercase). rank == ASCII order.
    code2 = np.full(256, 255, np.uint8)
    for i, b in enumerate(ACGT):
        code2[ord(b)] = i
        code2[ord(b.lower())] = i  # lowercase maps to same code; validity is
        # controlled separately by the softmask policy tables.
    # 4-bit: all IUPAC letters. rank == ASCII order of uppercase letters.
    code4 = np.full(256, 255, np.uint8)
    for i, b in enumerate(IUPAC_LETTERS):
        code4[ord(b)] = i
        code4[ord(b.lower())] = i
    # complement permutations in code space
    comp2 = np.array([3, 2, 1, 0], np.uint8)  # A<->T, C<->G
    comp4 = np.zeros(16, np.uint8)
    for i, b in enumerate(IUPAC_LETTERS):
        comp4[i] = IUPAC_LETTERS.index(COMPLEMENT[b])
    comp4[15] = 15
    return code2, code4, comp2, comp4


CODE2_TABLE, CODE4_TABLE, COMP2_TABLE, COMP4_TABLE = _build_tables()

#: decode tables: code -> uppercase ASCII byte
DECODE2 = np.frombuffer(ACGT.encode(), np.uint8).copy()
DECODE4 = np.frombuffer((IUPAC_LETTERS + "?").encode(), np.uint8).copy()


def base_validity_table(bits: int, disallow: str = "", omit_soft: bool = False) -> np.ndarray:
    """Per-ASCII-byte validity for window extraction.

    A base is valid when it is in the encoding alphabet, is not in
    ``disallow`` (both cases as given, matching kstream's literal char set,
    kstream.py:715-732), and — when ``omit_soft`` — is not lowercase
    (kstream.py:734-749).
    """
    valid = np.zeros(256, np.bool_)
    letters = ACGT if bits == 2 else IUPAC_LETTERS
    for b in letters:
        valid[ord(b)] = True
        if not omit_soft:
            valid[ord(b.lower())] = True
    for ch in disallow:
        valid[ord(ch)] = False
    return valid


def choose_bits(data: np.ndarray) -> int:
    """Pick the narrowest per-base encoding covering ``data`` (ASCII uint8).

    Returns 2 when only A/C/G/T/N (either case) appear, else 4.  ``N`` is
    permitted in the 2-bit scan because it is masked out by validity rather
    than encoded.
    """
    ok2 = np.zeros(256, np.bool_)
    for b in "ACGTNacgtn":
        ok2[ord(b)] = True
    ok2[0] = True  # record-separator sentinel
    counts = np.bincount(data.reshape(-1), minlength=256)
    return 2 if counts[~ok2].sum() == 0 else 4


def decode_bits(words: np.ndarray, offsets, bits: int) -> list[str]:
    """Decode base fields at explicit bit offsets from packed key words.

    ``words``: (n, W) uint32; ``offsets``: absolute bit offset per base
    (each field guaranteed word-aligned by KeyLayout).  Vectorized host
    decode of the compacted survivor rows.
    """
    n = words.shape[0]
    table = DECODE2 if bits == 2 else DECODE4
    mask = (1 << bits) - 1
    chars = np.empty((n, len(offsets)), np.uint8)
    for i, off in enumerate(offsets):
        w, bit = off // 32, off % 32
        sh = 32 - bit - bits
        chars[:, i] = table[(words[:, w] >> np.uint32(sh)) & np.uint32(mask)]
    return [bytes(row).decode() for row in chars]


def extract_bit_field(words: np.ndarray, off: int, width: int) -> np.ndarray:
    """Extract an integer field (e.g. the genome id) from packed keys."""
    w, bit = off // 32, off % 32
    sh = 32 - bit - width
    return (words[:, w] >> np.uint32(sh)) & np.uint32((1 << width) - 1)


def decode_words(words: np.ndarray, length: int, bits: int) -> list[str]:
    """Decode packed key words back to strings (host, vectorized).

    ``words``: (n, W) uint32 array in pack order (16 or 8 bases per word,
    most-significant first).  Returns ``n`` strings of ``length`` bases in the
    packed order (i.e. the permuted [left|right|mid] layout — callers undo the
    permutation themselves).
    """
    per_word = 32 // bits
    n, W = words.shape
    chars = np.empty((n, length), np.uint8)
    table = DECODE2 if bits == 2 else DECODE4
    mask = (1 << bits) - 1
    for pos in range(length):
        w = pos // per_word
        j = pos % per_word
        sh = 32 - bits * (j + 1)
        code = (words[:, w] >> np.uint32(sh)) & np.uint32(mask)
        chars[:, pos] = table[code]
    return [bytes(row).decode() for row in chars]
