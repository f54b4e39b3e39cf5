"""Times the sort and window-key kernels of a checkout on the main path's
shapes, so that two checkouts compare on one card in one call.

    python krisp_tpu_torch/tools/kernel_times.py [--root DIR] [--reps 5]

``--root`` is the checkout whose ``krisp_tpu_torch`` is imported (default:
this one); run it as a script, not with ``-m``, so that the package comes
from there.  It uses only entry points that every version of the port has:
``ops.sort.sort_words``, ``ops.pack.window_keys_both``,
``engine.pipeline.genome_key_tables`` and ``ops.intersect.prefilter_rows``.
Tables: the spacer (25/1/2) and amplicon (30/40/30) paths' global tables of
five random 4 Mb genomes, the IUPAC path's rows after the prefilter (one
ambiguity letter every 100,000 bases), and 10M rows of 3 words of heavy
ties and sentinel rows; window keys on one 4 Mb buffer.  Prints one JSON
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
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_kernel = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            ms, calls = by_kernel.get(e.key[:40], (0.0, 0))
            by_kernel[e.key[:40]] = (ms + e.self_device_time_total / reps
                                     / 1e3, calls + e.count / reps)
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


def run(reps: int = 5, size: int = 4_000_000) -> dict:
    import torch
    from krisp_tpu_torch.engine.pipeline import (KmerGeometry,
                                                 genome_key_tables)
    from krisp_tpu_torch.ops.intersect import prefilter_rows
    from krisp_tpu_torch.ops.pack import window_keys_both
    from krisp_tpu_torch.ops.sort import sort_words

    if not torch.cuda.is_available():
        raise RuntimeError("kernel_times needs a CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    out = dict(gpu=smi[0], sort={}, window_keys={})
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
