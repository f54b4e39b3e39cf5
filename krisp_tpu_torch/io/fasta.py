"""Host-side streaming FASTA reader (plain / .gz / .bz2, file or stdin).

Replaces the reference's line-generator input layer
(reference src/krisp/kstream/kstream.py:458-583: ``_read_file``,
``_detect_FASTA``, ``_parse_FASTA``) with a buffer-oriented reader that
produces one contiguous uint8 ASCII buffer per file, records separated by a
single NUL sentinel byte (invalid under every encoding, so no k-mer window
ever crosses a record boundary — the reference gets the same guarantee by
k-merizing record-by-record).
"""

from __future__ import annotations

import bz2
import gzip
import io
import sys
import weakref
from pathlib import Path

import numpy as np

from ..dna import choose_bits

_GZ_MAGIC = b"\x1f\x8b"
_BZ2_MAGIC = b"BZh"

SENTINEL = 0  # NUL byte between records


def open_maybe_compressed(path):
    """Open a path ('-' = stdin) transparently handling gzip/bz2.  The
    returned handle owns its file descriptor (closing it closes the fd —
    a decompressor wrapped around a caller-opened fileobj would not)."""
    if path == "-" or path is None:
        return sys.stdin.buffer
    with open(path, "rb") as raw:
        magic = raw.read(3)
    if magic[:2] == _GZ_MAGIC:
        return gzip.open(path, "rb")
    if magic == _BZ2_MAGIC:
        return bz2.open(path, "rb")
    return open(path, "rb")


def iter_fasta_records(path):
    """Yield (name, sequence_bytes) per FASTA record; header-less input is
    treated as one-sequence-per-line raw text (parity: kstream.py:510-554)."""
    handle = open_maybe_compressed(path)
    try:
        first = True
        is_fasta = False
        name = None
        chunks: list[bytes] = []
        for line in handle:
            line = line.strip()
            if first:
                is_fasta = line.startswith(b">")
                first = False
            if is_fasta:
                if line.startswith(b">"):
                    if chunks:
                        yield name, b"".join(chunks)
                    name = (line[1:].split()[0].decode()
                            if len(line) > 1 else "")
                    chunks = []
                else:
                    chunks.append(line)
            else:
                if line:
                    yield None, line
        if is_fasta and chunks:
            yield name, b"".join(chunks)
    finally:
        # close even when a consumer abandons the generator mid-file
        if handle is not sys.stdin.buffer:
            handle.close()


def read_fasta_buffer(path, pad_to: int | None = None):
    """Read a whole FASTA file into one sentinel-separated uint8 buffer.

    Returns (buffer uint8[N], record_names).  ``pad_to`` rounds the buffer up
    with sentinel bytes to a static size (jit-shape bucketing).
    """
    parts = []
    names = []
    for name, seq in iter_fasta_records(path):
        names.append(name)
        parts.append(np.frombuffer(seq, np.uint8))
        parts.append(np.zeros(1, np.uint8))
    if not parts:
        buf = np.zeros(1, np.uint8)
    else:
        buf = np.concatenate(parts)
    if pad_to is not None and buf.size < pad_to:
        buf = np.concatenate([buf, np.zeros(pad_to - buf.size, np.uint8)])
    return buf, names


# the encoding width the native reader gave each buffer it returned, by the
# buffer's id; an entry goes as its buffer dies (the weakref's callback), so
# an id found here is that buffer's
_READER_BITS: dict[int, tuple[weakref.ref, int]] = {}


def _keep_reader_bits(buf: np.ndarray, bits: int) -> None:
    key = id(buf)
    _READER_BITS[key] = (weakref.ref(buf, lambda _: _READER_BITS.pop(key)),
                         bits)


def load_buffer(path) -> np.ndarray:
    """Genome buffer for the device engine: native C++ reader when
    available (csrc/host/fastaio.cpp via io.native), Python fallback otherwise.
    Both produce the identical sentinel-separated layout (pinned by
    tests/test_native_io.py)."""
    if path != "-" and not str(path).endswith(".bz2"):
        from .native import read_fasta_native
        got = read_fasta_native(path)
        if got is not None:
            _keep_reader_bits(*got)
            return got[0]
    return read_fasta_buffer(path)[0]


def genome_bits(buf: np.ndarray) -> tuple[int, bool]:
    """(bits, by_reader): the per-base encoding width ``buf`` takes
    (``dna.choose_bits``'s answer on it), and whether the native reader gave
    it as it copied the bases of this very array (true), or ``choose_bits``
    scanned it now (false: a buffer of the Python reader — ``.bz2``, stdin,
    no native library — or any array ``load_buffer`` did not return)."""
    if id(buf) in _READER_BITS:
        return _READER_BITS[id(buf)][1], True
    return choose_bits(buf), False


def bucket_size(n: int, quantum: int = 1 << 16) -> int:
    """Round a buffer size up to a bucket to bound jit recompiles."""
    return ((n + quantum - 1) // quantum) * quantum


# --- file naming helpers (parity: krisp_fasta/shared.py:34-73) -------------

_FASTA_EXTS = {"gz", "bz2", "fna", "fasta", "fa", "ffn", "frn"}


def fasta_basename(filename: str) -> str:
    """Basename with fasta/compression extensions stripped."""
    parts = Path(filename).name.split(".")
    while len(parts) > 1 and parts[-1] in _FASTA_EXTS:
        parts.pop()
    return ".".join(parts)


def simple_name(filename: str) -> str:
    """Label used to tag k-mers with their source genome."""
    return fasta_basename(filename).split(".")[0]
