"""ctypes bridge to the native VCF tokenizer (csrc/host/vcfio.cpp, the
port's copy of krisp_tpu's csrc/vcfio.cpp), built on demand into the
port's own ``io/_native/libkrispvcf.so``.

Produces columnar arrays directly consumable by ops/vcfclass.classify_batch,
plus lightweight record views compatible with the host engine — the
GB-scale input path for whole-genome VCF scans.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

from ..nativebuild import load_native

_LIB = Path(__file__).resolve().parent / "_native" / "libkrispvcf.so"
_lock = threading.Lock()
_lib = None
_build_failed = False


class _KVcf(ctypes.Structure):
    _fields_ = [
        ("sample_blob", ctypes.POINTER(ctypes.c_char)),
        ("sample_blob_len", ctypes.c_size_t),
        ("n_samples", ctypes.c_int32),
        ("n_records", ctypes.c_int64),
        ("max_alleles", ctypes.c_int32),
        ("pos", ctypes.POINTER(ctypes.c_int64)),
        ("qual", ctypes.POINTER(ctypes.c_double)),
        ("mq", ctypes.POINTER(ctypes.c_double)),
        ("n_alleles", ctypes.POINTER(ctypes.c_int32)),
        ("chrom_id", ctypes.POINTER(ctypes.c_int32)),
        ("chrom_blob", ctypes.POINTER(ctypes.c_char)),
        ("chrom_blob_len", ctypes.c_size_t),
        ("allele_blob", ctypes.POINTER(ctypes.c_char)),
        ("allele_blob_len", ctypes.c_size_t),
        ("allele_off", ctypes.POINTER(ctypes.c_int64)),
        ("n_allele_strings", ctypes.c_int64),
        ("dp", ctypes.POINTER(ctypes.c_int32)),
        ("gq", ctypes.POINTER(ctypes.c_int32)),
        ("ad", ctypes.POINTER(ctypes.c_int32)),
        ("rlen", ctypes.POINTER(ctypes.c_int32)),
        ("alen", ctypes.POINTER(ctypes.c_int32)),
    ]


class _KIdx(ctypes.Structure):
    _fields_ = [
        ("sample_blob", ctypes.POINTER(ctypes.c_char)),
        ("sample_blob_len", ctypes.c_size_t),
        ("chrom_blob", ctypes.POINTER(ctypes.c_char)),
        ("chrom_blob_len", ctypes.c_size_t),
        ("n_records", ctypes.c_int64),
        ("max_alleles", ctypes.c_int32),
        ("file_end", ctypes.c_int64),
        ("chrom_id", ctypes.POINTER(ctypes.c_int32)),
        ("pos", ctypes.POINTER(ctypes.c_int64)),
        ("off", ctypes.POINTER(ctypes.c_int64)),
        ("rlen", ctypes.POINTER(ctypes.c_int32)),
    ]


def get_lib():
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        lib = load_native("vcfio.cpp", _LIB, extra_flags=["-pthread", "-lz"])
        if lib is None:
            _build_failed = True
            return None
        lib.kvcf_read.restype = ctypes.POINTER(_KVcf)
        lib.kvcf_read.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.kvcf_read_range.restype = ctypes.POINTER(_KVcf)
        lib.kvcf_read_range.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                        ctypes.c_int64, ctypes.c_int64]
        lib.kvcf_read_anchored.restype = ctypes.POINTER(_KVcf)
        lib.kvcf_read_anchored.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                           ctypes.POINTER(ctypes.c_int64),
                                           ctypes.POINTER(ctypes.c_int64),
                                           ctypes.c_int]
        lib.kvcf_free.argtypes = [ctypes.POINTER(_KVcf)]
        lib.kvcf_index.restype = ctypes.POINTER(_KIdx)
        lib.kvcf_index.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        lib.kvcf_index_free.argtypes = [ctypes.POINTER(_KIdx)]
        lib.kvcf_window_types.restype = None
        lib.kvcf_window_types.argtypes = (
            [ctypes.POINTER(ctypes.c_int64)] * 3
            + [ctypes.POINTER(ctypes.c_uint8)] * 2
            + [ctypes.c_int64] * 3
            + [ctypes.POINTER(ctypes.c_int8),
               ctypes.POINTER(ctypes.c_int64)])
        _lib = lib
        return lib


def read_index(path, out_plain=None):
    """One native pass over a VCF: per-record (chrom_id, pos, byte offset,
    REF length), contig/sample names, global max allele count, and — when
    ``out_plain`` is given — the decompressed bytes written there (the
    offsets address that stream).  None when the library is unavailable or
    the file is malformed (callers fall back to the Python indexer)."""
    lib = get_lib()
    if lib is None:
        return None
    ptr = lib.kvcf_index(str(path).encode(),
                         str(out_plain).encode() if out_plain else b"")
    if not ptr:
        return None
    try:
        c = ptr.contents
        V = int(c.n_records)
        samples = (ctypes.string_at(c.sample_blob, c.sample_blob_len)
                   .decode().split("\0")[:-1] if c.sample_blob_len else [])
        chroms = (ctypes.string_at(c.chrom_blob, c.chrom_blob_len)
                  .decode().split("\0")[:-1] if c.chrom_blob_len else [])

        def arr(p, dt):
            return (np.ctypeslib.as_array(p, (V,)).copy() if V
                    else np.zeros(0, dt))

        return {"samples": samples, "chroms": chroms,
                "max_alleles": int(c.max_alleles),
                "file_end": int(c.file_end),
                "chrom_id": arr(c.chrom_id, np.int32),
                "pos": arr(c.pos, np.int64),
                "off": arr(c.off, np.int64),
                "rlen": arr(c.rlen, np.int32)}
    finally:
        lib.kvcf_index_free(ptr)


def window_types_native(starts, ends, delta, is_diag, is_consv, span,
                        min_vars):
    """Native sliding-window replay (csrc kvcf_window_types); None when
    the library is unavailable.  Bit-equal to fastscan._window_types
    (fuzz-pinned by tests/test_native_vcf.py)."""
    lib = get_lib()
    if lib is None:
        return None
    starts = np.ascontiguousarray(starts, np.int64)
    ends = np.ascontiguousarray(ends, np.int64)
    delta = np.ascontiguousarray(delta, np.int64)
    is_diag = np.ascontiguousarray(is_diag, np.uint8)
    is_consv = np.ascontiguousarray(is_consv, np.uint8)
    V = starts.shape[0]
    types = np.empty(V, np.int8)
    jstart = np.empty(V, np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.kvcf_window_types(
        starts.ctypes.data_as(i64p), ends.ctypes.data_as(i64p),
        delta.ctypes.data_as(i64p), is_diag.ctypes.data_as(u8p),
        is_consv.ctypes.data_as(u8p), V, int(span), int(min_vars),
        types.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        jstart.ctypes.data_as(i64p))
    return types, jstart


class _NativeOwner:
    """Frees one native KVcf when the last zero-copy view over it dies
    (every view's ``base`` chain holds a reference here)."""

    __slots__ = ("_lib", "_ptr")

    def __init__(self, lib, ptr):
        self._lib = lib
        self._ptr = ptr

    def __del__(self):
        try:
            self._lib.kvcf_free(self._ptr)
        except Exception:
            pass


_NP_OF_CTYPE = {ctypes.c_int32: np.int32, ctypes.c_int64: np.int64,
                ctypes.c_double: np.float64}


def _view(cptr, shape, owner):
    """Zero-copy numpy view over a native array, lifetime-tied to owner."""
    n = 1
    for s in shape:
        n *= s
    if n == 0:  # zero samples/alleles: data() may be NULL
        return np.zeros(shape, _NP_OF_CTYPE[cptr._type_])
    buf = (cptr._type_ * n).from_address(
        ctypes.addressof(cptr.contents))
    buf._owner = owner  # numpy base -> ctypes buf -> owner -> kvcf_free
    return np.ctypeslib.as_array(buf).reshape(shape)


class _LazyAlleles:
    """Per-record allele tuples decoded on demand from the native
    NUL-separated blob (most records' allele strings are never read by the
    scan; eager decode was ~25% of the columnar load)."""

    __slots__ = ("_blob", "_off", "_n", "_bounds")

    def __init__(self, blob, allele_off, n_alleles):
        self._blob = blob          # bytes, NUL after every allele string
        self._off = allele_off     # string index of record's first allele
        self._n = n_alleles
        self._bounds = None

    def _byte_bounds(self):
        if self._bounds is None:
            nul = np.nonzero(np.frombuffer(self._blob, np.uint8) == 0)[0]
            starts = np.empty_like(nul)
            starts[0] = 0
            starts[1:] = nul[:-1] + 1
            self._bounds = (starts, nul)
        return self._bounds

    def __len__(self):
        return len(self._off)

    def __getitem__(self, v):
        if isinstance(v, slice):
            return [self[i] for i in range(*v.indices(len(self._off)))]
        starts, stops = self._byte_bounds()
        o = int(self._off[v])
        blob = self._blob
        return tuple(blob[starts[j]:stops[j]].decode()
                     for j in range(o, o + int(self._n[v])))

    def __iter__(self):
        return (self[i] for i in range(len(self._off)))

    def __eq__(self, other):
        if isinstance(other, (list, tuple)):
            return list(self) == list(other)
        return NotImplemented


class ColumnarVcf:
    """Whole-file columnar VCF (native parse); None when unavailable."""

    def __init__(self, samples, chroms, chrom_id, pos, qual, mq, n_alleles,
                 alleles, dp, gq, ad, rlen=None, alen=None):
        self.samples = samples
        self.chroms = chroms
        self.chrom_id = chrom_id
        self.pos = pos
        self.qual = qual
        self.mq = mq
        self.n_alleles = n_alleles
        self.alleles = alleles      # per-record allele tuples (maybe lazy)
        self.dp = dp                # (V, S) int32, -1 missing
        self.gq = gq
        self.ad = ad                # (V, S, A) int32
        if rlen is not None:
            self._rlen = rlen
        if alen is not None:
            self._alen = alen

    @property
    def n_records(self):
        return len(self.pos)

    @property
    def rlen(self):
        """REF-allele length per record (int32[V])."""
        if not hasattr(self, "_rlen"):
            self._rlen = np.fromiter((len(a[0]) for a in self.alleles),
                                     np.int32, len(self.alleles))
        return self._rlen

    @property
    def alen(self):
        """Allele nucleotide length per (record, allele index), int32[V, A];
        '*' counts as 0 (find_diag_var.py allele_lens semantics), padding -1."""
        if not hasattr(self, "_alen"):
            V, A = self.ad.shape[0], self.ad.shape[2]
            out = np.full((V, A), -1, np.int32)
            for v, alls in enumerate(self.alleles):
                for a, s in enumerate(alls[:A]):
                    out[v, a] = 0 if s == "*" else len(s)
            self._alen = out
        return self._alen


def read_columnar(path, max_alleles=8, start=0, end=-1, anchors=None):
    """Columnar arrays for the records whose lines start in byte range
    [start, end) of the (decompressed) stream; the default range is the
    whole file.  Ranged loads bound memory by the slice — the device scan
    loads one contig at a time (vcf/parser.columnar_slice).

    ``anchors``: optional ``(byte_offsets, row_starts)`` — ascending
    record-line byte offsets splitting [start, end) into spans parsed by
    parallel threads, plus each span's first row index (both ending with
    the exclusive totals; from the byte-offset index).  Element-identical
    output: threads write the bulk genotype arrays in place at their row
    offsets.  Only for PLAIN (already-decompressed) files: a gz handle
    would re-inflate from byte 0 per thread (the C side refuses and this
    falls back to the ranged parse)."""
    lib = get_lib()
    if lib is None:
        return None
    ptr = None
    if anchors is not None and len(anchors[0]) >= 2:
        offs, rows = anchors
        arr = (ctypes.c_int64 * len(offs))(*[int(a) for a in offs])
        rarr = (ctypes.c_int64 * len(rows))(*[int(r) for r in rows])
        ptr = lib.kvcf_read_anchored(str(path).encode(), max_alleles,
                                     arr, rarr, len(offs) - 1)
    if not ptr:   # no anchors, or anchored refused (gzip input)
        ptr = lib.kvcf_read_range(str(path).encode(), max_alleles,
                                  int(start), int(end))
    if not ptr:
        return None
    c = ptr.contents
    V, S, A = int(c.n_records), int(c.n_samples), int(c.max_alleles)
    samples = (ctypes.string_at(c.sample_blob, c.sample_blob_len)
               .decode().split("\0")[:-1] if c.sample_blob_len else [])
    chroms = (ctypes.string_at(c.chrom_blob, c.chrom_blob_len)
              .decode().split("\0")[:-1] if c.chrom_blob_len else [])
    if V == 0:
        # empty range/file: the C++ vectors' data() may be NULL, which
        # np.ctypeslib.as_array rejects even at length 0
        lib.kvcf_free(ptr)
        return ColumnarVcf(samples, chroms,
                           np.zeros(0, np.int32), np.zeros(0, np.int64),
                           np.zeros(0), np.zeros(0),
                           np.zeros(0, np.int32), [],
                           np.zeros((0, S), np.int32),
                           np.zeros((0, S), np.int32),
                           np.zeros((0, S, A), np.int32))
    # zero-copy views over the native arrays: the parse result is consumed
    # once by the vectorized scan, so the former eager full-array copies
    # (the AD cube alone is V*S*A*4 bytes) bought nothing; every view's
    # base chain keeps `owner` (and so the native buffers) alive
    owner = _NativeOwner(lib, ptr)
    pos = _view(c.pos, (V,), owner)
    qual = _view(c.qual, (V,), owner)
    mq = _view(c.mq, (V,), owner)
    n_alleles = _view(c.n_alleles, (V,), owner)
    chrom_id = _view(c.chrom_id, (V,), owner)
    blob = ctypes.string_at(c.allele_blob, c.allele_blob_len)
    allele_off = _view(c.allele_off, (V,), owner)
    alleles = _LazyAlleles(blob, allele_off, n_alleles)
    dp = _view(c.dp, (V, S), owner)
    gq = _view(c.gq, (V, S), owner)
    ad = _view(c.ad, (V, S, A), owner)
    rlen = _view(c.rlen, (V,), owner)
    alen = _view(c.alen, (V, A), owner)
    return ColumnarVcf(samples, chroms, chrom_id, pos, qual, mq, n_alleles,
                       alleles, dp, gq, ad, rlen=rlen, alen=alen)
