"""Times variants of the survivor-scan kernel's source against each other
on one card, in turns, to find what bounds it.

    python -m krisp_tpu_torch.tools.scan_variants VARIANTS [--rounds 2]

VARIANTS is a JSON object {name: edits}: ``edits`` maps a constant of
``csrc/survivor_scan.cu`` (``kTile``, ``kThreads``, ...) to its new value,
and its key ``"replace"`` holds [old, new] text replacements, each of
which must match once (a step taken out behind a runtime condition that
never holds, for example).  ``{}`` is the source as it is.  A variant
whose key ``"exact"`` is false is timed without its outputs being held to
the plain version.  Each variant builds with the package's nvcc flags
into ``_build/variants/``, and runs in layout mode on the spacer (25/1/2)
global table of five random 4 Mb genomes, the IUPAC path's rows after
the prefilter and 10M rows of long runs, all sorted; tables as
``tools/kernel_times.py`` makes them.  Prints one line per variant and
table: event ms, busy ms and the busy time by kernel.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

from ..kernels import build
from .kernel_times import _genomes, _times, long_runs_table


def _source(edits: dict) -> str:
    src = (build.SRC_DIR / "survivor_scan.cu").read_text()
    for key, value in edits.items():
        if key == "exact":
            continue
        if key == "replace":
            for old, new in value:
                if src.count(old) != 1:
                    raise ValueError(f"{old!r} does not match once")
                src = src.replace(old, new)
            continue
        src, hits = re.subn(rf"constexpr int {key} = \d+;",
                            f"constexpr int {key} = {int(value)};", src)
        if hits != 1:
            raise ValueError(f"no constant {key}")
    return src


def _build(variants: dict) -> dict:
    """{name: ctypes library} built in parallel, one nvcc each."""
    out = build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in variants.items():
        cu = out / f"{name}.cu"
        cu.write_text(_source(edits))
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o",
             str(out / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{err}")
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        for fn in ("krisp_survivor_scan", "krisp_survivor_scan_block_rows"):
            getattr(lib, fn).argtypes, getattr(lib, fn).restype = \
                build._SIGNATURES[fn]
        libs[name] = lib
    return libs


def _call(lib, keys, layout, n_files=5):
    """One call of a variant in layout mode, as ``ops/scan`` makes it."""
    import torch
    W, n = keys.shape
    nb = -(-n // lib.krisp_survivor_scan_block_rows())
    dev = keys.device
    state = torch.empty(1 + 2 * nb, dtype=torch.int64, device=dev)
    open_ = torch.empty((nb, 4), dtype=torch.int32, device=dev)
    out = (torch.empty(n, dtype=torch.bool, device=dev),
           torch.empty(n, dtype=torch.int32, device=dev),
           torch.empty(n, dtype=torch.int32, device=dev))
    fw, fsh = layout.file_word_shift()
    build.check(lib.krisp_survivor_scan(
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
        keys.data_ptr(), W, n, None, fw, fsh, layout.file_sentinel,
        layout.flank_bits, layout.file_off + layout.file_bits, n_files,
        state.data_ptr(), open_.data_ptr(), *(t.data_ptr() for t in out)),
        "survivor_scan variant")
    return out


def run(variants: dict, rounds: int = 2, size: int = 4_000_000):
    import torch
    from ..engine.pipeline import KmerGeometry, genome_key_tables
    from ..ops.intersect import prefilter_rows
    from ..ops.scan import survivor_scan_layout_reference
    from ..ops.sort import sort_words

    if not torch.cuda.is_available():
        raise RuntimeError("scan_variants needs a CUDA device")
    dev = torch.device("cuda", 0)
    libs = _build(variants)
    tables = {}
    with tempfile.TemporaryDirectory() as td:
        for name, iupac in (("spacer_2w", False),
                            ("iupac_prefilter_4w", True)):
            flat, layout = genome_key_tables(_genomes(Path(td), size, iupac),
                                             KmerGeometry(25, 1, 2),
                                             device=dev)
            if iupac:
                flat = flat[:, prefilter_rows(flat, layout, 5)]
            tables[name] = (sort_words(flat), layout)
            del flat
    tables["long_runs_2w"] = long_runs_table(np.random.default_rng(7),
                                             10_000_017, dev)
    for tname, (keys, layout) in tables.items():
        want = survivor_scan_layout_reference(keys, layout, 5)
        for name, lib in libs.items():
            if variants[name].get("exact", True):
                got = _call(lib, keys, layout)
                torch.cuda.synchronize()
                if not all(torch.equal(g, r) for g, r in zip(got, want)):
                    raise RuntimeError(f"variant {name} differs on {tname}")
        del want
    for r in range(rounds):
        for name in list(libs)[::-1 if r % 2 else 1]:
            for tname, (keys, layout) in tables.items():
                t = _times(lambda: _call(libs[name], keys, layout), 10)
                print(json.dumps(dict(variant=name, table=tname, **t)),
                      flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", help="JSON object {name: edits}")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    run(json.loads(args.variants), args.rounds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
