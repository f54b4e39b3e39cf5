"""Builds the port's CUDA kernels at first use and binds them with ctypes.

Every ``krisp_tpu_torch/csrc/*.cu`` compiles with its own ``nvcc``, all
started together, and the objects link into one shared library with a
plain C interface (no PyTorch headers, so the build takes seconds).  The
library lands in ``krisp_tpu_torch/_build/`` under a name keyed by a hash
of the sources and flags, so an edited source rebuilds and a stale binary
is never loaded.  The C entries take raw device pointers and
the CUDA stream as integers and return the ``cudaError_t`` of their
launches; ``check`` turns a non-zero code into an exception.

There is no fallback: a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_P, _I, _U, _LL = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                   ctypes.c_longlong)
#: C entry -> (argtypes, restype)
_SIGNATURES = {
    "krisp_window_keys": ([_I, _P, _P, _LL, _I, _I, _P, _I, _I, _P, _P, _P],
                          _I),
    "krisp_window_keys_table": ([_I, _P, _P, _LL, _I, _I, _P, _I, _I, _P, _LL,
                                 _I, _U], _I),
    "krisp_window_keys_max_runs": ([], _I),
    "krisp_window_keys_max_len": ([], _I),
    "krisp_survivor_scan": ([_I, _P, _P, _I, _LL, _P, _I, _I, _U, _I, _I, _I,
                             _P, _P, _P, _P, _P], _I),
    "krisp_survivor_scan_block_rows": ([], _I),
    "krisp_survivor_scan_ahead_rows": ([], _I),
    "krisp_sort_words_vary": ([_I, _P, _P, _I, _LL, _P], _I),
    "krisp_sort_words": ([_I, _P, _P, _I, _LL, _P, _I, _P, _P, _P, _P], _I),
    "krisp_sort_words_block_rows": ([], _I),
    "krisp_sort_words_max_words": ([], _I),
    "krisp_sort_words_max_bits": ([], _I),
    "krisp_sort_words_key_mode_words": ([], _I),
    "krisp_sort_words_status_words": ([_LL], _LL),
    "krisp_merge_words": ([_I, _P, _P, _LL, _P, _LL, _I, _P, _P], _I),
    "krisp_merge_words_max_words": ([], _I),
    "krisp_merge_words_tile_rows": ([_I], _I),
    "krisp_error_string": ([_I], ctypes.c_char_p),
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.access(path, os.X_OK):
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "krisp_tpu_torch need the CUDA toolkit to build")
    return path


def build() -> Path:
    """Compile the kernel library if no build of these sources exists;
    returns its path."""
    sources = sorted(SRC_DIR.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(SRC_DIR.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    lib = BUILD_DIR / f"libkrisp_kernels-{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in sources]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                                   str(src)], stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for src, obj in zip(sources, objs)]
        errors = []
        for src, proc in zip(sources, procs):
            _, err = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{src.name} (exit {proc.returncode}):\n{err}")
        if errors:
            raise RuntimeError("nvcc failed: " + "\n".join(errors))
        out = Path(tmp) / lib.name
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(out), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed (exit {proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stderr}")
        os.replace(out, lib)
    return lib


@functools.cache
def load_library() -> ctypes.CDLL:
    """The built kernel library with every C entry's signature declared."""
    lib = ctypes.CDLL(str(build()))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error."""
    if err:
        msg = load_library().krisp_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
