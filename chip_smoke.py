#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (krisp_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It imports no JAX.  Phases, each printing one line (any failure raises and
exits non-zero; nothing is caught):

  0. environment: torch / CUDA / nvcc versions, the card's name and power
     limit;
  1. build both CUDA kernels from ``krisp_tpu_torch/csrc`` (build seconds);
  2. window-key kernel vs its plain PyTorch version on a 4 Mb buffer with
     N and lower-case runs, at 25/1/2, 4/1/3 and 10/4/10, omit_soft off
     and on: exact; median of 5 CUDA-event timings of each;
  3. survivor-scan kernel vs its plain version on the sorted key table of
     phase 4's genomes and on a table with long runs at every granularity:
     exact; timings of both and of the key sort;
  4. the main path through ``krisp_tpu_torch.cli.krisp_fasta.main`` on 5
     synthetic genomes (bench.py's recipe: seed 7, 3 planted 28-base
     regions, genomes 0-1 ingroup; plus one region whose middle base tells
     the ingroup apart), geometry 25/1/2: at 5 x 1 Mb the CUDA and CPU runs
     write equal, non-empty CSV and alignment bytes, and ``run_pipeline``
     without the ingroup filter gives the same groups (flanks, mids, label
     counts) on both devices, equal to the planted known answer; at
     5 x 4 Mb one warm-up and 3 timed runs, with both kernels' launch
     counters reset just before and required to have moved.
Then a ``details`` line with every measurement as JSON, one JSON line of
per-kernel results, the ``nvidia-smi`` name/power line, and, last,
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

N_FILES = 5
GEOM = (25, 1, 2)
L = sum(GEOM)
SEED = 7


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, reps=5):
    """Median CUDA-event time of ``fn`` in ms, after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def max_abs_err(got, want, rows=None):
    errs = []
    for g, w in zip(got, want):
        g, w = g.to(torch.int64), w.to(torch.int64)
        if rows is not None and g.dim() == 2:
            g, w = g[:, rows], w[:, rows]
        errs.append(int((g - w).abs().max()) if g.numel() else 0)
    return max(errs)


def revcomp(s: str) -> str:
    return s.translate(str.maketrans("ACGT", "TGCA"))[::-1]


def synth_genomes(tmpdir: Path, size: int):
    """bench.py's synth_genomes (N_FILES random genomes sharing 3 planted
    L-base regions) plus one diagnostic region: shared flanks whose middle
    base is A in the ingroup (genomes 0-1) and C in the outgroup, so the
    ingroup filter keeps it.  Returns (paths, planted): planted[f] is the
    list of regions written into genome f."""
    tmpdir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(SEED)
    shared = ["".join(rng.choice(list("ACGT"), size=L)) for _ in range(3)]
    diag_rng = np.random.default_rng(SEED + 1)   # leaves bench's stream as is
    left, right = ("".join(diag_rng.choice(list("ACGT"), size=n))
                   for n in (GEOM[0], GEOM[2]))
    paths, planted = [], []
    for f in range(N_FILES):
        seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=size)
        seq = bytearray(seq.tobytes())
        regions = [(size // 8, left + ("A" if f < 2 else "C") + right)]
        regions += [((i + 1) * size // (len(shared) + 1), p)
                    for i, p in enumerate(shared)]
        for pos, p in regions:
            seq[pos:pos + L] = p.encode()
        planted.append([p for _, p in regions])
        path = tmpdir / f"genome{f}.fasta"
        with open(path, "w") as fh:
            fh.write(f">synthetic_{f}\n")
            s = seq.decode()
            for i in range(0, len(s), 80):
                fh.write(s[i:i + 80] + "\n")
        paths.append(str(path))
    return paths, planted


def phase_env():
    nvcc = subprocess.run(["nvcc", "--version"], capture_output=True,
                          text=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    nvcc_v = (nvcc.stdout.strip().splitlines() or ["?"])[-1]
    print(f"phase 0 env: python {sys.version.split()[0]} torch "
          f"{torch.__version__} cuda {torch.version.cuda} nvcc {nvcc_v!r} "
          f"gpu {smi[0]!r}", flush=True)
    return smi[0]


def phase_build():
    from krisp_tpu_torch.kernels import build
    t0 = time.perf_counter()
    lib = build.load_library()
    dt = time.perf_counter() - t0
    print(f"phase 1 build: {dt:.2f} s ({build.build().name})", flush=True)
    check(lib.krisp_survivor_scan_block_rows() > 0, "kernel library broken")
    return dt


def phase_window_keys(dev, n_bytes):
    from krisp_tpu_torch.ops.pack import (window_keys_both,
                                          window_keys_both_reference)
    rng = np.random.default_rng(SEED)
    buf = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=n_bytes)
    for start in rng.integers(0, n_bytes - 2000, 400):   # soft-masked runs
        buf[start:start + rng.integers(50, 2000)] |= 0x20
    for start in rng.integers(0, n_bytes - 200, 200):    # assembly gaps
        buf[start:start + rng.integers(1, 200)] = ord("N")
    buf[rng.random(n_bytes) < 1e-3] = ord("n")
    b = torch.from_numpy(buf).to(dev)
    results = []
    for geom in (GEOM, (4, 1, 3), (10, 4, 10)):
        for omit in (False, True):
            args = (b, *geom, 2, N_FILES, omit)
            got = window_keys_both(*args)
            want = window_keys_both_reference(*args)
            torch.cuda.synchronize()
            ok = want[0]
            check(torch.equal(got[0], ok), f"window ok differs at {geom}")
            err = max_abs_err(got[1:], want[1:], rows=ok)
            check(err == 0, f"window words differ at {geom} omit={omit}")
            check(bool(ok.any()), f"no valid window at {geom} omit={omit}")
            ms = cuda_ms(lambda: window_keys_both(*args))
            plain_ms = cuda_ms(lambda: window_keys_both_reference(*args))
            results.append(dict(geom=list(geom), omit_soft=omit,
                                n_win=int(ok.numel()),
                                valid=int(ok.sum()), max_abs_err=err,
                                ms=ms, plain_ms=plain_ms))
            print(f"phase 2 window_keys {geom} omit_soft={omit}: exact, "
                  f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
                  f"{int(ok.sum())}/{ok.numel()} valid windows", flush=True)
    return results


def _sorted_table(paths, dev):
    """The main path's global table for these genomes, built by the
    pipeline's own table stage: keys int32[W, n] before and after the sort,
    plus validity."""
    from krisp_tpu_torch.engine.pipeline import (KmerGeometry,
                                                 genome_key_tables)
    from krisp_tpu_torch.ops.intersect import valid_rows
    from krisp_tpu_torch.ops.sort import lsd_sort

    keys, layout = genome_key_tables(paths, KmerGeometry(*GEOM), device=dev)
    flat = torch.cat(keys, dim=1)       # as fused_global_packed does
    del keys
    words = torch.stack(lsd_sort(list(flat))[0])
    return layout, flat, words, valid_rows(words, layout)


def _long_run_table(dev, n):
    from krisp_tpu_torch.ops.encode import KeyLayout
    rng = np.random.default_rng(SEED)
    layout = KeyLayout(*GEOM, 2, N_FILES)
    words = np.stack([rng.integers(0, 4, n).astype(np.uint32) << 28
                      for _ in range(layout.n_words)])
    fw, fsh = layout.file_word_shift()
    words[fw] &= ~np.uint32(layout.file_sentinel << fsh)
    ids = rng.integers(0, N_FILES, n).astype(np.uint32)
    ids[rng.random(n) < 0.05] = layout.file_sentinel
    words[fw] |= ids << fsh
    words = words[:, np.lexsort(tuple(words[::-1]))]
    valid = ((words[fw] >> np.uint32(fsh)) & np.uint32(layout.file_sentinel)
             ) != layout.file_sentinel
    return (layout, torch.from_numpy(words.view(np.int32)).to(dev),
            torch.from_numpy(valid).to(dev))


def phase_scan(dev, paths):
    from krisp_tpu_torch.ops.scan import (survivor_scan,
                                          survivor_scan_reference)
    from krisp_tpu_torch.ops.sort import lsd_sort

    layout, flat, words, valid = _sorted_table(paths, dev)
    sort_ms = cuda_ms(lambda: lsd_sort(list(flat)))
    print(f"phase 3 sort: {flat.shape[1]} rows x {flat.shape[0]} words, "
          f"torch.sort {sort_ms:.3f} ms", flush=True)
    del flat
    results = []
    for name, (layout, w, v) in (
            ("main_path_table", (layout, words, valid)),
            ("long_runs", _long_run_table(dev, 10_000_017))):
        args = (w, v, layout.flank_bits, layout.file_off + layout.file_bits,
                N_FILES)
        got = survivor_scan(*args)
        want = survivor_scan_reference(*args)
        torch.cuda.synchronize()
        for g, r, what in zip(got, want, ("keep", "counts", "gid")):
            check(g.dtype == r.dtype and torch.equal(g, r),
                  f"survivor scan {what} differs on {name}")
        n_keep = int(want[0].sum())
        check(n_keep > 0, f"no survivor in {name}")
        ms = cuda_ms(lambda: survivor_scan(*args))
        plain_ms = cuda_ms(lambda: survivor_scan_reference(*args))
        results.append(dict(table=name, rows=int(w.shape[1]), n_keep=n_keep,
                            max_abs_err=max_abs_err(got, want), ms=ms,
                            plain_ms=plain_ms))
        print(f"phase 3 survivor_scan {name}: {w.shape[1]} rows, exact, "
              f"{n_keep} survivors, kernel {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms", flush=True)
    return results, sort_ms


def _cli(paths, device, out_dir: Path):
    from krisp_tpu_torch.cli.krisp_fasta import main
    csv, align = out_dir / f"{device}.csv", out_dir / f"{device}.txt"
    rc = main([*paths[:2], "--outgroup", *paths[2:], "--conserved-left",
               str(GEOM[0]), "--conserved-right", str(GEOM[2]),
               "--diagnostic", str(GEOM[1]), "--device", device,
               "--out_csv", str(csv), "--out_align", str(align)])
    check(rc == 0, f"krisp_fasta exit {rc} on {device}")
    return csv.read_bytes(), align.read_bytes()


def _planted_groups(planted):
    """Known answer: the flank groups of the planted regions (both strands)
    that every genome holds, as {(left, right): {mid: {label: count}}}."""
    flanks = {}
    for f, regions in enumerate(planted):
        for p in regions:
            for s in (p, revcomp(p)):
                key = (s[:GEOM[0]], s[GEOM[0] + GEOM[1]:])
                mids = flanks.setdefault(key, {})
                labels = mids.setdefault(s[GEOM[0]:GEOM[0] + GEOM[1]], {})
                labels[f"genome{f}"] = labels.get(f"genome{f}", 0) + 1
    return {k: v for k, v in flanks.items()
            if len(set().union(*v.values())) == N_FILES}


def _groups_as_dict(groups):
    return {(g.left, g.right): {a.mid: dict(a.label_counts)
                                for a in g.amplicons} for g in groups}


def phase_main_path(dev, small, large, out_dir):
    from krisp_tpu_torch.engine.pipeline import KmerGeometry, run_pipeline
    from krisp_tpu_torch.metrics import GLOBAL as METRICS
    from krisp_tpu_torch.ops.pack import window_keys_both
    from krisp_tpu_torch.ops.scan import survivor_scan

    (paths_s, planted), paths_l = small, large
    t0 = time.perf_counter()
    cuda_out = _cli(paths_s, "cuda", out_dir)
    t_cuda = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_out = _cli(paths_s, "cpu", out_dir)
    t_cpu = time.perf_counter() - t0
    csv_rows = cuda_out[0].count(b"\n") - 1
    check(csv_rows > 0 and len(cuda_out[1]) > 0,
          "the ingroup filter kept nothing at 5 x 1 Mb")
    check(cuda_out == cpu_out, "CUDA and CPU CLI outputs differ at 5 x 1 Mb")
    # every survivor group, unfiltered: CUDA equals CPU (flanks, mids and
    # label counts) and equals the planted known answer
    unfiltered = {}
    for d in (dev, "cpu"):
        unfiltered[str(d)] = _groups_as_dict(run_pipeline(
            paths_s[:2], paths_s[2:], KmerGeometry(*GEOM),
            ingroup_filter=False, device=d))
    check(unfiltered[str(dev)] == unfiltered["cpu"],
          "CUDA and CPU survivor groups differ at 5 x 1 Mb")
    want = _planted_groups(planted)
    check(unfiltered["cpu"] == want,
          f"survivor groups {unfiltered['cpu']} != planted {want}")
    print(f"phase 4 main path 5 x 1 Mb: CUDA CLI ({t_cuda:.2f} s) == CPU "
          f"CLI ({t_cpu:.2f} s), {csv_rows} CSV rows; {len(want)} planted "
          "groups found, CUDA == CPU", flush=True)

    _cli(paths_l, "cuda", out_dir)                      # warm-up
    METRICS.reset()
    torch.cuda.reset_peak_memory_stats(dev)
    window_keys_both.launches = 0
    survivor_scan.launches = 0
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        _cli(paths_l, "cuda", out_dir)
        times.append(time.perf_counter() - t0)
    launches = {"window_keys_both": window_keys_both.launches,
                "survivor_scan": survivor_scan.launches}
    peak = torch.cuda.max_memory_allocated(dev)
    n_keep = METRICS.stages["pull"].items // 3
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the main path never launched: {launches}")
    check(n_keep > 0, "no survivor rows at 5 x 4 Mb")
    size = 4_000_000
    n_keys = N_FILES * 2 * (size - L + 1)      # both strands, as bench.py
    rate = n_keys / min(times)
    stages = {k: v.seconds / 3 for k, v in METRICS.stages.items()}
    print(f"phase 4 main path 5 x 4 Mb: runs {[round(t, 4) for t in times]} "
          f"s, {rate:,.0f} k-mers/s (best), n_keep {n_keep}, peak device "
          f"memory {peak / 2**20:.1f} MiB, launches {launches}", flush=True)
    print("phase 4 stages (mean s per run): "
          + ", ".join(f"{k} {v:.4f}" for k, v in stages.items()), flush=True)
    return dict(times_s=times, kmers_per_s=rate, n_keys=n_keys,
                n_keep=n_keep, peak_bytes=peak, stages_s=stages,
                launches=launches, small_cuda_s=t_cuda, small_cpu_s=t_cpu)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import krisp_tpu_torch  # noqa: F401  (fails outside the repository)

    dev = torch.device("cuda", 0)
    smi = phase_env()
    build_s = phase_build()
    pack_res = phase_window_keys(dev, 4_063_232)
    with tempfile.TemporaryDirectory() as td:
        td = Path(td)
        small = synth_genomes(td / "1mb", 1_000_000)
        large = synth_genomes(td / "4mb", 4_000_000)[0]
        scan_res, sort_ms = phase_scan(dev, large)
        main_res = phase_main_path(dev, small, large, td)

    main_pack = pack_res[0]
    main_scan = scan_res[0]
    kernels = [
        dict(name="window_keys_both", route="cuda",
             source="krisp_tpu_torch/csrc/window_keys.cu",
             replaces="krisp_tpu/ops/pallas_pack.py:169",
             launches=main_res["launches"]["window_keys_both"],
             max_abs_err=max(r["max_abs_err"] for r in pack_res),
             ms=main_pack["ms"], plain_ms=main_pack["plain_ms"]),
        dict(name="survivor_scan", route="cuda",
             source="krisp_tpu_torch/csrc/survivor_scan.cu",
             replaces="krisp_tpu/ops/pallas_scan.py:218",
             launches=main_res["launches"]["survivor_scan"],
             max_abs_err=max(r["max_abs_err"] for r in scan_res),
             ms=main_scan["ms"], plain_ms=main_scan["plain_ms"]),
    ]
    print("details " + json.dumps(dict(
        gpu=smi, torch=torch.__version__, cuda=torch.version.cuda,
        build_s=build_s, window_keys=pack_res, survivor_scan=scan_res,
        sort_ms=sort_ms, main_path=main_res)))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
