#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (krisp_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It imports no JAX.  Phases, each printing one line per check (any failure
raises and exits non-zero; nothing is caught):

  0. environment: torch / CUDA / nvcc versions, the card's name and power
     limit;
  1. build the three CUDA kernels from ``krisp_tpu_torch/csrc``, one nvcc
     per source in parallel (build seconds);
  2. window-key kernel vs its plain PyTorch version on a 4 Mb buffer with
     N and lower-case runs, at 25/1/2, 4/1/3, 10/4/10 and 30/40/30,
     omit_soft off and on: exact; median of 5 CUDA-event timings of each;
  3. sort kernel vs its plain version (``lsd_sort``, ``torch.sort``
     passes) on four tables, exact, with median CUDA-event times of both:
     the spacer path's global table (40.6M rows x 2 words), the IUPAC
     path's rows after the prefilter (about 40M x 4, built by the
     pipeline's own stages), the 30/40/30 table the direct path would sort
     (40.6M x 7) and a table of heavy ties, sentinel rows and top-bit
     words; then the survivor-scan kernel vs its plain version on the
     tables the global stage scans, sorted by the sort kernel as the
     pipeline sorts them (the spacer table, 2 words; the rows the
     prefilter keeps on the IUPAC path, 4 words, and on the amplicon path,
     7 words), and on a table with long runs at every granularity;
  4-6. three paths through ``krisp_tpu_torch.cli.krisp_fasta.main``, on 5
     synthetic genomes each (bench.py's recipe: seed 7, 3 planted shared
     regions of the window length, genomes 0-1 ingroup; plus one planted
     diagnostic region whose middle differs between ingroup and outgroup):
       4. spacer 25/1/2 (2-bit keys);
       5. amplicon 30/40/30 (2-bit, 7-word keys through the prefix
          prefilter), the CLI without and with ``--primer3``;
       6. IUPAC spacer 25/1/2 (one ambiguity letter every 100,000 bases
          turns every key to 4 bits: 4 words, through the prefilter), the
          CLI with ``--dot-alignment``.
     At 5 x 1 Mb the CUDA and CPU CLI runs write equal CSV and alignment
     bytes (at least one CSV row where the ingroup filter runs alone), and
     ``run_pipeline`` without the ingroup filter gives the same groups
     (flanks, mids, label counts) on both devices, equal to the planted
     known answer.  At 5 x 4 Mb one warm-up and 3 timed runs, with every
     launch counter reset just before and each kernel of the path required
     to have launched.
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
SPACER = (25, 1, 2)
AMPLICON = (30, 40, 30)
SEED = 7
SMALL, LARGE = 1_000_000, 4_000_000
IUPAC_EVERY = 100_000


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


def synth_genomes(tmpdir: Path, size: int, geom, iupac: bool = False):
    """bench.py's synth_genomes (N_FILES random genomes sharing 3 planted
    regions of the window length) plus one diagnostic region: shared
    flanks whose middle is one random sequence in the ingroup (genomes 0-1)
    and differs from it at every base in the outgroup, so the ingroup
    filter keeps it.  ``iupac`` writes one ambiguity letter every
    IUPAC_EVERY bases before the regions are planted.  Returns (paths,
    planted): planted[f] is the list of regions written into genome f."""
    tmpdir.mkdir(parents=True, exist_ok=True)
    left, mid, right = geom
    L = sum(geom)
    rng = np.random.default_rng(SEED)
    shared = ["".join(rng.choice(list("ACGT"), size=L)) for _ in range(3)]
    diag_rng = np.random.default_rng(SEED + 1)   # leaves bench's stream as is
    fl, fr = ("".join(diag_rng.choice(list("ACGT"), size=n))
              for n in (left, right))
    mid_in = "".join(diag_rng.choice(list("ACGT"), size=mid))
    mid_out = mid_in.translate(str.maketrans("ACGT", "CATG"))
    paths, planted = [], []
    for f in range(N_FILES):
        seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=size)
        if iupac:
            pos = np.arange(IUPAC_EVERY // 2, size, IUPAC_EVERY)
            seq[pos] = np.frombuffer(b"RYSWKM", np.uint8)[
                np.arange(pos.size) % 6]
        seq = bytearray(seq.tobytes())
        regions = [(size // 8, fl + (mid_in if f < 2 else mid_out) + fr)]
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


def kernel_wrappers():
    """The kernel wrappers by name; each counts its launches."""
    from krisp_tpu_torch.ops.pack import window_keys_both
    from krisp_tpu_torch.ops.scan import survivor_scan
    from krisp_tpu_torch.ops.sort import sort_words
    return {"window_keys_both": window_keys_both, "sort_words": sort_words,
            "survivor_scan": survivor_scan}


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
    sources = sorted(p.name for p in build.SRC_DIR.glob("*.cu"))
    print(f"phase 1 build: {dt:.2f} s ({build.build().name}, {sources})",
          flush=True)
    check(len(sources) == 3, f"expected three kernel sources: {sources}")
    check(lib.krisp_survivor_scan_block_rows() > 0
          and lib.krisp_sort_words_block_rows() > 0
          and lib.krisp_window_keys_max_len() > 0, "kernel library broken")
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
    for geom in (SPACER, (4, 1, 3), (10, 4, 10), AMPLICON):
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


def _key_table(paths, geom, dev):
    """A path's global table for these genomes, built by the pipeline's
    own table stage: (layout, keys int32[W, n])."""
    from krisp_tpu_torch.engine.pipeline import (KmerGeometry,
                                                 genome_key_tables)
    flat, layout = genome_key_tables(paths, KmerGeometry(*geom), device=dev)
    return layout, flat


def _tie_table(dev, V, n):
    """Few distinct words (heavy ties), top-bit words and sentinel rows."""
    rng = np.random.default_rng(SEED)
    pool = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xC0000000, 0xFFFFFFFE,
                     0xFFFFFFFF], np.uint32)
    words = pool[rng.integers(0, pool.size, (V, n))]
    words[:, rng.random(n) < 0.1] = 0xFFFFFFFF
    return torch.from_numpy(words.view(np.int32)).to(dev)


def _long_run_table(dev, n):
    from krisp_tpu_torch.ops.encode import KeyLayout
    rng = np.random.default_rng(SEED)
    layout = KeyLayout(*SPACER, 2, N_FILES)
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


def _check_sort(name, table):
    from krisp_tpu_torch.ops.sort import sort_words, sort_words_reference
    got = sort_words(table)
    want = sort_words_reference(table)
    torch.cuda.synchronize()
    err = max_abs_err([got], [want])
    check(err == 0 and torch.equal(got, want),
          f"sort kernel differs from its plain version on {name}")
    del got, want
    ms = cuda_ms(lambda: sort_words(table))
    plain_ms = cuda_ms(lambda: sort_words_reference(table))
    V, n = table.shape
    print(f"phase 3 sort_words {name}: {n} rows x {V} words, exact, "
          f"kernel {ms:.3f} ms, plain (torch.sort) {plain_ms:.3f} ms",
          flush=True)
    return dict(table=name, rows=n, words=V, max_abs_err=err, ms=ms,
                plain_ms=plain_ms)


def phase_sort(dev, spacer, amplicon, iupac):
    """The sort kernel on four tables.  Returns (results, the scan phase's
    tables {name: (layout, keys sorted by sort_words, as the pipeline's
    global stage sorts them)}): the spacer table and the rows the
    prefilter keeps on the IUPAC and amplicon paths."""
    from krisp_tpu_torch.ops.intersect import prefilter_rows
    from krisp_tpu_torch.ops.sort import sort_words

    results, scan_tables = [], {}
    layout, flat = _key_table(spacer, SPACER, dev)
    results.append(_check_sort("spacer_path_table", flat))
    scan_tables["spacer_path_table"] = (layout, sort_words(flat))
    del flat

    layout, flat = _key_table(iupac, SPACER, dev)
    sub = flat[:, prefilter_rows(flat, layout, N_FILES)]
    del flat
    results.append(_check_sort("iupac_prefilter_subset", sub))
    scan_tables["iupac_prefilter_subset"] = (layout, sort_words(sub))
    del sub

    layout, flat = _key_table(amplicon, AMPLICON, dev)
    results.append(_check_sort("amplicon_direct_table", flat))
    sub = flat[:, prefilter_rows(flat, layout, N_FILES)]
    del flat
    scan_tables["amplicon_prefilter_subset"] = (layout, sort_words(sub))
    del sub

    results.append(_check_sort("ties_sentinels", _tie_table(dev, 3,
                                                            10_000_019)))
    return results, scan_tables


def phase_scan(dev, scan_tables):
    """The survivor-scan kernel vs its plain version on each path's sorted
    table (2, 4 and 7 words) and on a table of long runs: keep, counts and
    gid exact, with median CUDA-event times of both."""
    from krisp_tpu_torch.ops.intersect import valid_rows
    from krisp_tpu_torch.ops.scan import (survivor_scan,
                                          survivor_scan_reference)

    tables = {k: (layout, w, valid_rows(w, layout))
              for k, (layout, w) in scan_tables.items()}
    tables["long_runs"] = _long_run_table(dev, 10_000_017)
    results = []
    for name, (layout, w, v) in tables.items():
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
        W, n = w.shape
        results.append(dict(table=name, rows=n, words=W, n_keep=n_keep,
                            max_abs_err=max_abs_err(got, want), ms=ms,
                            plain_ms=plain_ms))
        print(f"phase 3 survivor_scan {name}: {n} rows x {W} words, exact, "
              f"{n_keep} survivors, kernel {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms", flush=True)
    return results


def _geom_flags(geom):
    if geom == AMPLICON:
        return ["--conserved", str(geom[0]), "--amplicon", str(sum(geom))]
    return ["--conserved-left", str(geom[0]), "--conserved-right",
            str(geom[2]), "--diagnostic", str(geom[1])]


def _cli(paths, geom, device, out_dir: Path, flags=()):
    from krisp_tpu_torch.cli.krisp_fasta import main
    csv, align = out_dir / f"{device}.csv", out_dir / f"{device}.txt"
    rc = main([*paths[:2], "--outgroup", *paths[2:], *_geom_flags(geom),
               *flags, "--device", device, "--out_csv", str(csv),
               "--out_align", str(align)])
    check(rc == 0, f"krisp_fasta exit {rc} on {device}")
    return csv.read_bytes(), align.read_bytes()


def _planted_groups(planted, geom):
    """Known answer: the flank groups of the planted regions (both strands)
    that every genome holds, as {(left, right): {mid: {label: count}}}."""
    left, mid, _ = geom
    flanks = {}
    for f, regions in enumerate(planted):
        for p in regions:
            for s in (p, revcomp(p)):
                key = (s[:left], s[left + mid:])
                mids = flanks.setdefault(key, {})
                labels = mids.setdefault(s[left:left + mid], {})
                labels[f"genome{f}"] = labels.get(f"genome{f}", 0) + 1
    return {k: v for k, v in flanks.items()
            if len(set().union(*v.values())) == N_FILES}


def _groups_as_dict(groups):
    return {(g.left, g.right): {a.mid: dict(a.label_counts)
                                for a in g.amplicons} for g in groups}


def phase_path(n, name, geom, dev, small, large, out_dir, variants, kernels):
    """One path through the CLI: CUDA == CPU bytes at 5 x 1 Mb for each
    flag variant (the first must hold at least one CSV row), the
    unfiltered groups on both devices equal to the planted answer, then 3
    timed runs at 5 x 4 Mb in which every kernel of ``kernels`` launched."""
    from krisp_tpu_torch.engine.pipeline import KmerGeometry, run_pipeline
    from krisp_tpu_torch.metrics import GLOBAL as METRICS

    (paths_s, planted), paths_l = small, large
    small_res = []
    for i, flags in enumerate(variants):
        t0 = time.perf_counter()
        cuda_out = _cli(paths_s, geom, "cuda", out_dir, flags)
        t_cuda = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu_out = _cli(paths_s, geom, "cpu", out_dir, flags)
        t_cpu = time.perf_counter() - t0
        csv_rows = cuda_out[0].count(b"\n") - 1
        if i == 0:
            check(csv_rows > 0 and len(cuda_out[1]) > 0,
                  f"{name}: the ingroup filter kept nothing at 5 x 1 Mb")
        check(cuda_out == cpu_out,
              f"{name}: CUDA and CPU CLI outputs differ at 5 x 1 Mb {flags}")
        small_res.append(dict(flags=list(flags), csv_rows=csv_rows,
                              cuda_s=t_cuda, cpu_s=t_cpu))
        print(f"phase {n} {name} 5 x 1 Mb {list(flags)}: CUDA CLI "
              f"({t_cuda:.2f} s) == CPU CLI ({t_cpu:.2f} s), {csv_rows} CSV "
              "rows", flush=True)
    # every survivor group, unfiltered: CUDA equals CPU (flanks, mids and
    # label counts) and equals the planted known answer
    unfiltered = {}
    for d in (dev, "cpu"):
        unfiltered[str(d)] = _groups_as_dict(run_pipeline(
            paths_s[:2], paths_s[2:], KmerGeometry(*geom),
            ingroup_filter=False, device=d))
    check(unfiltered[str(dev)] == unfiltered["cpu"],
          f"{name}: CUDA and CPU survivor groups differ at 5 x 1 Mb")
    want = _planted_groups(planted, geom)
    check(unfiltered["cpu"] == want,
          f"{name}: survivor groups {unfiltered['cpu']} != planted {want}")
    print(f"phase {n} {name} 5 x 1 Mb: {len(want)} planted groups found, "
          "CUDA == CPU", flush=True)

    _cli(paths_l, geom, "cuda", out_dir, variants[0])          # warm-up
    METRICS.reset()
    torch.cuda.reset_peak_memory_stats(dev)
    for fn in kernel_wrappers().values():
        fn.launches = 0
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        _cli(paths_l, geom, "cuda", out_dir, variants[0])
        times.append(time.perf_counter() - t0)
    launches = {k: fn.launches for k, fn in kernel_wrappers().items()}
    peak = torch.cuda.max_memory_allocated(dev)
    n_keep = METRICS.stages["pull"].items // 3
    gather = METRICS.stages.get("gather")
    n_pre = gather.items // 3 if gather is not None else None
    check(all(launches[k] > 0 for k in kernels),
          f"{name}: a kernel of the path never launched: {launches}")
    check(n_keep > 0, f"{name}: no survivor rows at 5 x 4 Mb")
    n_keys = N_FILES * 2 * (LARGE - sum(geom) + 1)   # both strands, as bench
    rate = n_keys / min(times)
    stages = {k: v.seconds / 3 for k, v in METRICS.stages.items()}
    print(f"phase {n} {name} 5 x 4 Mb: runs {[round(t, 4) for t in times]} "
          f"s, {rate:,.0f} k-mers/s (best), n_pre {n_pre}, n_keep {n_keep}, "
          f"peak device memory {peak / 2**20:.1f} MiB, launches {launches}",
          flush=True)
    print(f"phase {n} {name} stages (mean s per run): "
          + ", ".join(f"{k} {v:.4f}" for k, v in stages.items()), flush=True)
    return dict(small=small_res, planted_groups=len(want), times_s=times,
                kmers_per_s=rate, n_keys=n_keys, n_pre=n_pre, n_keep=n_keep,
                peak_bytes=peak, stages_s=stages, launches=launches)


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
        genomes = {}
        for name, geom, iupac in (("spacer", SPACER, False),
                                  ("amplicon", AMPLICON, False),
                                  ("iupac", SPACER, True)):
            genomes[name] = (
                synth_genomes(td / f"{name}_1mb", SMALL, geom, iupac),
                synth_genomes(td / f"{name}_4mb", LARGE, geom, iupac)[0])
        sort_res, scan_tables = phase_sort(
            dev, *(genomes[k][1] for k in ("spacer", "amplicon", "iupac")))
        scan_res = phase_scan(dev, scan_tables)
        del scan_tables
        torch.cuda.empty_cache()
        paths = {}
        for n, name, geom, variants, kernels in (
                (4, "spacer", SPACER, [()], list(kernel_wrappers())),
                (5, "amplicon", AMPLICON, [(), ("--primer3",)],
                 list(kernel_wrappers())),
                (6, "iupac", SPACER, [("--dot-alignment",)],
                 ("sort_words", "survivor_scan"))):
            out_dir = td / f"out_{name}"
            out_dir.mkdir()
            paths[name] = phase_path(n, name, geom, dev, *genomes[name],
                                     out_dir, variants, kernels)

    main_pack = pack_res[0]
    main_scan = scan_res[0]
    main_sort = sort_res[0]
    main_launches = paths["spacer"]["launches"]
    kernels = [
        dict(name="window_keys_both", route="cuda",
             source="krisp_tpu_torch/csrc/window_keys.cu",
             replaces="krisp_tpu/ops/pallas_pack.py:169",
             launches=main_launches["window_keys_both"],
             max_abs_err=max(r["max_abs_err"] for r in pack_res),
             ms=main_pack["ms"], plain_ms=main_pack["plain_ms"]),
        dict(name="sort_words", route="cuda",
             source="krisp_tpu_torch/csrc/sort_words.cu",
             replaces="krisp_tpu/ops/pallas_sort.py:173",
             launches=main_launches["sort_words"],
             max_abs_err=max(r["max_abs_err"] for r in sort_res),
             ms=main_sort["ms"], plain_ms=main_sort["plain_ms"]),
        dict(name="survivor_scan", route="cuda",
             source="krisp_tpu_torch/csrc/survivor_scan.cu",
             replaces="krisp_tpu/ops/pallas_scan.py:218",
             launches=main_launches["survivor_scan"],
             max_abs_err=max(r["max_abs_err"] for r in scan_res),
             ms=main_scan["ms"], plain_ms=main_scan["plain_ms"]),
    ]
    print("details " + json.dumps(dict(
        gpu=smi, torch=torch.__version__, cuda=torch.version.cuda,
        build_s=build_s, window_keys=pack_res, sort_words=sort_res,
        survivor_scan=scan_res, paths=paths)))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
