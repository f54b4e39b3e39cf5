"""Shared on-demand builder for the port's C++ host helpers under
``krisp_tpu_torch/csrc/host/`` (copies of krisp_tpu's ``csrc/fastaio.cpp``,
``csrc/thermochain.cpp``, ``csrc/kstreamcore.cpp`` and ``csrc/vcfio.cpp``;
each binary lands in the port's own ``_native/`` folders, so the port never
loads one the JAX package built).

Each native bridge (io/native.py, io/native_vcf.py, thermo/chain.py) builds
its library lazily at first use.  Staleness is keyed on a sha256 of the
source stored beside the binary — NOT on mtimes, because a fresh git clone
gives source and binary identical mtimes and would otherwise happily load a
foreign-arch binary forever.  The compile uses -mtune (not -march) so a
binary that does survive in a build cache still runs on any x86-64 host,
and -ffp-contract=off so float results match the pure-Python fallbacks
bit-for-bit (no FMA contraction).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

_SRC = Path(__file__).resolve().parent / "csrc" / "host"


def load_native(src_name: str, lib_path: Path, extra_flags=()):
    """Build (if stale) and dlopen ``csrc/host/<src_name>``; None on any
    failure.

    When the source tree is absent (installed package without csrc/host/), an
    existing binary is trusted as-is; with neither, the caller's pure-Python
    fallback takes over.
    """
    src = _SRC / src_name
    lib_path = Path(lib_path)
    hash_path = lib_path.with_name(lib_path.name + ".srchash")
    if not src.exists():
        return _dlopen(lib_path) if lib_path.exists() else None
    digest = hashlib.sha256(src.read_bytes()).hexdigest()
    if (not lib_path.exists() or not hash_path.exists()
            or hash_path.read_text().strip() != digest):
        lib_path.parent.mkdir(exist_ok=True)
        # processes that build at once (test workers) each link their own
        # file and rename it into place, so none loads a half-written one
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        cmd = ["g++", "-O3", "-mtune=native", "-ffp-contract=off", "-shared",
               "-fPIC", str(src), *extra_flags, "-o", str(tmp)]
        try:
            proc = subprocess.run(cmd, capture_output=True, timeout=120)
        except (OSError, subprocess.TimeoutExpired):
            tmp.unlink(missing_ok=True)
            return None
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            return None
        os.replace(tmp, lib_path)
        hash_path.write_text(digest)
    return _dlopen(lib_path)


def _dlopen(lib_path: Path):
    try:
        return ctypes.CDLL(str(lib_path))
    except OSError:
        return None
