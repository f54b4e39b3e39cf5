"""Times the sort, window-key and survivor-scan kernels of a checkout on
the main path's shapes, so that two checkouts compare on one card in one
call.

    python krisp_tpu_torch/tools/kernel_times.py [--root DIR] [--reps 5]

``--root`` is the checkout whose ``krisp_tpu_torch`` is imported (default:
this one); run it as a script, not with ``-m``, so that the package comes
from there.  It uses only entry points that every version of the port has:
``ops.sort.sort_words``, ``ops.pack.window_keys_both``,
``engine.pipeline.genome_key_tables``, ``ops.intersect.prefilter_rows``
and ``ops.scan.survivor_scan`` (with a validity array; where the checkout
has it, ``survivor_scan_layout`` is timed too).  Tables: the spacer
(25/1/2) and amplicon (30/40/30) paths' global tables of five random 4 Mb
genomes, the IUPAC path's rows after the prefilter (one ambiguity letter
every 100,000 bases), and 10M rows of 3 words of heavy ties and sentinel
rows; window keys on one 4 Mb buffer; the survivor scan on the spacer
and IUPAC tables once sorted and on 10M rows of 2-word keys in 16 flank
groups of long runs.  Prints one JSON
line: per case the median CUDA-event time of a call (``ms``), the card's
busy time of a call (``busy_ms``, profiler) and that busy time by kernel
(``by_kernel``: ms a call and launches a call, under the first 40
characters of each kernel's name), with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np


def _times(fn, reps):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    event = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        event.append(start.elapsed_time(end))
    by_kernel = {}
    for _ in range(3):   # the profiler now and then returns an empty trace
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                ms, calls = by_kernel.get(e.key[:40], (0.0, 0))
                by_kernel[e.key[:40]] = (ms + e.self_device_time_total / reps
                                         / 1e3, calls + e.count / reps)
        if by_kernel:
            break
    return dict(ms=float(np.median(event)),
                busy_ms=sum(ms for ms, _ in by_kernel.values()),
                by_kernel=dict(sorted(by_kernel.items(),
                                      key=lambda kv: -kv[1][0])))


def _genomes(tmp: Path, size: int, iupac: bool, seed: int = 7):
    rng = np.random.default_rng(seed)
    paths = []
    for f in range(5):
        seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=size)
        if iupac:
            pos = np.arange(50_000, size, 100_000)
            seq[pos] = np.frombuffer(b"RYSWKM", np.uint8)[np.arange(pos.size)
                                                          % 6]
        path = tmp / f"g{f}_{int(iupac)}.fasta"
        path.write_bytes(b">g\n" + seq.tobytes() + b"\n")
        paths.append(str(path))
    return paths


def long_runs_table(rng, n, dev):
    """Sorted 2-word spacer keys (25/1/2, 5 genomes) whose words take 4
    values in their top bits: 16 flank groups of about n / 16 rows, each
    a few long runs, some rows sentinel.  Returns (keys, layout)."""
    import torch
    from krisp_tpu_torch.ops.encode import KeyLayout
    layout = KeyLayout(25, 1, 2, 2, 5)
    words = np.stack([rng.integers(0, 4, n).astype(np.uint32) << 28
                      for _ in range(layout.n_words)])
    fw, fsh = layout.file_word_shift()
    words[fw] &= ~np.uint32(layout.file_sentinel << fsh)
    ids = rng.integers(0, 5, n).astype(np.uint32)
    ids[rng.random(n) < 0.05] = layout.file_sentinel
    words[fw] |= ids << fsh
    words = np.ascontiguousarray(words[:, np.lexsort(tuple(words[::-1]))])
    return torch.from_numpy(words.view(np.int32)).to(dev), layout


def run(reps: int = 5, size: int = 4_000_000) -> dict:
    import torch
    from krisp_tpu_torch.engine.pipeline import (KmerGeometry,
                                                 genome_key_tables)
    from krisp_tpu_torch.ops.intersect import prefilter_rows
    from krisp_tpu_torch.ops import scan
    from krisp_tpu_torch.ops.pack import window_keys_both
    from krisp_tpu_torch.ops.sort import sort_words

    if not torch.cuda.is_available():
        raise RuntimeError("kernel_times needs a CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    out = dict(gpu=smi[0], sort={}, window_keys={}, survivor_scan={})

    def time_scan(name, keys, layout):
        ff = layout.file_off + layout.file_bits
        fw, fsh = layout.file_word_shift()
        valid = ((keys[fw] >> fsh) & layout.file_sentinel
                 ) != layout.file_sentinel
        case = out["survivor_scan"][name] = dict(
            rows=keys.shape[1], words=keys.shape[0],
            valid_mode=_times(lambda: scan.survivor_scan(
                keys, valid, layout.flank_bits, ff, 5), reps))
        if hasattr(scan, "survivor_scan_layout"):
            case["layout_mode"] = _times(
                lambda: scan.survivor_scan_layout(keys, layout, 5), reps)

    with tempfile.TemporaryDirectory() as td:
        plain, iupac = (_genomes(Path(td), size, flag) for flag in (0, 1))
        for name, paths, geom, pre in (
                ("spacer_2w", plain, (25, 1, 2), False),
                ("iupac_prefilter_4w", iupac, (25, 1, 2), True),
                ("amplicon_7w", plain, (30, 40, 30), False)):
            flat, layout = genome_key_tables(paths, KmerGeometry(*geom),
                                             device=dev)
            if pre:
                flat = flat[:, prefilter_rows(flat, layout, 5)]
            out["sort"][name] = dict(rows=flat.shape[1],
                                     **_times(lambda: sort_words(flat), reps))
            if name != "amplicon_7w":
                flat = sort_words(flat)
                time_scan(name, flat, layout)
            del flat
            torch.cuda.empty_cache()
    rng = np.random.default_rng(7)
    pool = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xC0000000, 0xFFFFFFFE,
                     0xFFFFFFFF], np.uint32)
    words = pool[rng.integers(0, pool.size, (3, 10_000_019))]
    words[:, rng.random(words.shape[1]) < 0.1] = 0xFFFFFFFF
    ties = torch.from_numpy(words.view(np.int32)).to(dev)
    out["sort"]["ties_3w"] = dict(rows=ties.shape[1],
                                  **_times(lambda: sort_words(ties), reps))
    time_scan("long_runs_2w", *long_runs_table(rng, 10_000_017, dev))
    buf = torch.from_numpy(rng.choice(np.frombuffer(b"ACGT", np.uint8),
                                      size=size)).to(dev)
    for geom in ((25, 1, 2), (30, 40, 30)):
        out["window_keys"]["/".join(map(str, geom))] = _times(
            lambda: window_keys_both(buf, *geom, 2, 5), reps)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve()
                                          .parents[2]),
                    help="checkout whose krisp_tpu_torch is timed")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    print(json.dumps(dict(root=args.root, **run(args.reps))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
