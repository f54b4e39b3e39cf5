"""ctypes bridge to the native IO library (csrc/host/fastaio.cpp), with
on-demand build into ``io/_native/``.

The native reader produces the same sentinel-separated buffer as
io.fasta.read_fasta_buffer but scans bytes in C++ (one pass, zlib inflate) —
the GB-scale input path — and in the same pass the per-base encoding width
the buffer takes (``dna.choose_bits``'s answer).  Falls back to the Python
reader when the toolchain or zlib headers are unavailable.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

from ..nativebuild import load_native

_LIB = Path(__file__).resolve().parent / "_native" / "libkrispio.so"
_lock = threading.Lock()
_lib = None
_build_failed = False


class _KBuf(ctypes.Structure):
    _fields_ = [("data", ctypes.POINTER(ctypes.c_uint8)),
                ("len", ctypes.c_size_t),
                ("n_records", ctypes.c_size_t),
                ("bits", ctypes.c_int)]


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        lib = load_native("fastaio.cpp", _LIB, extra_flags=["-lz"])
        if lib is None:
            _build_failed = True
            return None
        lib.kfasta_read.restype = ctypes.POINTER(_KBuf)
        lib.kfasta_read.argtypes = [ctypes.c_char_p]
        lib.kbuf_free.argtypes = [ctypes.POINTER(_KBuf)]
        _lib = lib
        return lib


def read_fasta_native(path: str):
    """Native equivalent of io.fasta.read_fasta_buffer (record names are not
    materialized — the engine does not use them): (buffer, bits), where
    bits is the per-base encoding width (2 or 4) the reader found the
    buffer takes as it copied the bases; None where the library or the file
    cannot be opened."""
    lib = get_lib()
    if lib is None:
        return None
    ptr = lib.kfasta_read(str(path).encode())
    if not ptr:
        return None
    try:
        n = ptr.contents.len
        buf = np.ctypeslib.as_array(ptr.contents.data, shape=(n,)).copy()
        bits = ptr.contents.bits
    finally:
        lib.kbuf_free(ptr)
    return buf, bits
