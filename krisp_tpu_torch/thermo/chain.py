"""ctypes bridge to the exact structure-chain DP (csrc/host/thermochain.cpp).

`nn.batch_self_screens` / `nn.pair_screens_batch` collect every maximal
complementary match-run per candidate in one vectorized pass; this module
selects the best secondary structure over those runs EXHAUSTIVELY — any
number of helices joined by bulges/internal loops, no shortlist — the
structure grammar of libprimer3's thal (the reference's scoring engine,
reference src/krisp/krisp_fasta/Amplicon.py:143-151).

The hot path is the native Pareto chain DP (built on demand like
io/native.py); when no toolchain is available, or when
KRISP_TPU_THERMO_NATIVE=0, a pure-Python DP of independent lineage
(thermo/oracle.py — also the differential-test oracle) produces identical
results (pinned by tests/test_thermo_oracle.py).
"""

from __future__ import annotations

import ctypes
import math
import os
import threading
from pathlib import Path

import numpy as np

from ..nativebuild import load_native

_LIB = Path(__file__).resolve().parent / "_native" / "libkrispthermo.so"
_lock = threading.Lock()
_lib = None
_build_failed = False

_F64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_I32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_I64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")


def get_lib():
    """Load (building if needed) the native DP, or None."""
    global _lib, _build_failed
    if os.environ.get("KRISP_TPU_THERMO_NATIVE") == "0":
        return None
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        lib = load_native("thermochain.cpp", _LIB)
        if lib is None:
            _build_failed = True
            return None
        fn = lib.krisp_thermo_chain
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_int64, _I64,                    # n_cand, offsets
            _I32, _I32, _I32, _I32, _I32,            # i0 i1 k0 k1 len
            _F64, _F64,                              # dh ds
            ctypes.c_int32, ctypes.c_int32,          # inner_desc, hairpin
            ctypes.c_void_p,                         # end_i (or NULL)
            _F64, _F64, _F64, ctypes.c_int32,        # loop tables, max_loop
            ctypes.c_double, ctypes.c_double,        # tmm_ds, dangle5_ds
            ctypes.c_double,                         # t37
            ctypes.c_double, ctypes.c_double,        # salt_ds, rlogc
            ctypes.c_int32,                          # threads
            _F64,                                    # out
        ]
        _lib = lib
        return _lib


def _consts():
    from . import nn
    salt_ds = 0.368 * math.log(nn.effective_monovalent() / 1000.0)
    rlogc = nn.R_GAS * math.log(50.0 * 1e-9 / 4.0)
    return nn, salt_ds, rlogc


def _n_threads(n_cand: int) -> int:
    """DP team size: candidates are independent; small batches stay
    serial (thread spawn costs more than the work)."""
    if n_cand < 24:
        return 1
    return max(1, min(os.cpu_count() or 1, 4))


def _solve(runs, C, inner_desc, hairpin, end_i):
    """Run the chain DP; returns the (C, 4) [any_dh, any_ds, end_dh,
    end_ds] table (end columns zero when ``end_i`` is None)."""
    out = np.zeros((C, 4))
    if runs is None:
        return out
    keep = runs["len"] >= 2  # chain members; singles re-gated at len >= 3
    cand = np.ascontiguousarray(
        runs["cand"][keep].astype(np.int64, copy=False))
    if cand.size == 0:
        return out
    offsets = np.searchsorted(cand, np.arange(C + 1)).astype(np.int64)
    # boolean indexing already yields fresh contiguous arrays; the dtype
    # casts are no-ops when the run tables arrive int32/float64 (nn.py
    # builds them that way), so nothing here copies twice
    cols = {k: np.ascontiguousarray(
                runs[k][keep].astype(np.int32, copy=False))
            for k in ("i0", "i1", "k0", "k1", "len")}
    dh = np.ascontiguousarray(runs["dh"][keep].astype(np.float64,
                                                     copy=False))
    ds = np.ascontiguousarray(runs["ds"][keep].astype(np.float64,
                                                      copy=False))
    if end_i is not None:
        end_i = np.ascontiguousarray(
            np.broadcast_to(np.asarray(end_i), (C,)).astype(np.int32))
    nn, salt_ds, rlogc = _consts()
    lib = get_lib()
    if lib is None:
        return _solve_py(offsets, cols, dh, ds, C, inner_desc, hairpin,
                         end_i)
    lib.krisp_thermo_chain(
        C, offsets, cols["i0"], cols["i1"], cols["k0"], cols["k1"],
        cols["len"], dh, ds, int(inner_desc), int(hairpin),
        None if end_i is None else end_i.ctypes.data_as(ctypes.c_void_p),
        nn._BULGE_DS, nn._INTERNAL_DS, nn._HAIRPIN_DS, nn._MAX_LOOP,
        nn.TMM_DS, nn.DANGLE5_DS, nn._T37, salt_ds, rlogc,
        _n_threads(C), out.reshape(-1))
    return out


def _solve_py(offsets, cols, dh, ds, C, inner_desc, hairpin, end_i):
    """Pure-Python fallback: per-candidate DP via thermo/oracle.py (the
    independent implementation the native kernel is pinned against)."""
    from . import oracle
    out = np.zeros((C, 4))
    for c in range(C):
        lo, hi = int(offsets[c]), int(offsets[c + 1])
        if lo == hi:
            continue
        rl = [oracle._Run(int(cols["i0"][t]), int(cols["i1"][t]),
                          int(cols["k0"][t]), int(cols["k1"][t]),
                          float(dh[t]), float(ds[t]), int(cols["len"][t]))
              for t in range(lo, hi)]
        if hairpin:
            out[c, 0], out[c, 1] = oracle._best_hairpin(rl)
        else:
            out[c, 0], out[c, 1] = oracle._best_duplex(rl)
            if end_i is not None:
                out[c, 2], out[c, 3] = oracle._best_duplex(
                    rl, end_i=int(end_i[c]))
    return out


def duplex_structures(runs, C, end_i):
    """Best duplex structure per candidate under the exhaustive search:
    (any_dh, any_ds, end_dh, end_ds) arrays — ranked by bimolecular Tm,
    END anchored at the 3'-most helix ending exactly at ``end_i``."""
    out = _solve(runs, C, inner_desc=False, hairpin=False, end_i=end_i)
    return out[:, 0], out[:, 1], out[:, 2], out[:, 3]


def hairpin_structures(runs, C):
    """Best hairpin structure per candidate under the exhaustive search:
    (dh, ds) with ds including the terminal loop + closure terms, ranked
    by -dG37 (thal's minimum-free-energy selection)."""
    out = _solve(runs, C, inner_desc=True, hairpin=True, end_i=None)
    return out[:, 0], out[:, 1]
