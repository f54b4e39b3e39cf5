#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (krisp_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It imports no JAX.  Phases, each printing one line per check (any failure
raises and exits non-zero; nothing is caught):

  0. environment: torch / CUDA / nvcc versions, the card's name and power
     limit;
  1. build the four CUDA kernels from ``krisp_tpu_torch/csrc``, one nvcc
     per source in parallel (build seconds);
  2. window-key kernel vs its plain PyTorch versions on a 4 Mb buffer with
     N and lower-case runs, at 25/1/2, 4/1/3, 10/4/10 and 30/40/30,
     omit_soft off and on, in both modes: (ok, fwd, rc) as the TPU kernel
     gives them, and the per-genome table (both strands, genome id,
     sentinel rows) written into a column slice of a wider table, as the
     pipeline writes it: exact; each call timed as every phase times
     one: ``ms`` the median CUDA-event time of a call (host gaps
     included), and for a kernel also ``busy_ms``, the card's busy time
     per call (from a profiler trace of 5 calls; null where three traces
     in a row held no device event);
  3. sort kernel vs its plain version (``lsd_sort``, ``torch.sort``
     passes) on four tables, exact, timed as in phase 2, and, for keys of
     up to 2 words, one ``torch.sort`` of the fused int64 key (the library
     call for the same function, never called by the port):
     the spacer path's global table (40.6M rows x 2 words), the IUPAC
     path's rows after the prefilter (about 40M x 4, built by the
     pipeline's own stages), the 30/40/30 table the direct path would sort
     (40.6M x 7) and a table of heavy ties, sentinel rows and top-bit
     words; then the survivor-scan kernel in both its modes (validity
     from the keys, as the global stage calls it, and from an array) vs
     its plain version on the tables the global stage scans, sorted by
     the sort kernel as the pipeline sorts them (the spacer table, 2
     words; the rows the prefilter keeps on the IUPAC path, 4 words, and
     on the amplicon path, 7 words), on a table with long runs at every
     granularity and on one whose groups end on the kernel's tile and
     look-ahead edges, each mode's busy time split by kernel;
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
     to have launched;
  7. merge kernel vs its plain version (the sort of both runs), exact, with
     median CUDA-event times of both (and, for keys of up to 2 words, of
     one ``torch.sort`` of both runs' fused keys): the two sorted halves of the A/B data
     (2 x 20M rows x 2 words), the spacer table of genomes 0-2 and of
     genomes 3-4 sorted apart, the amplicon table (7 words) split the same
     way, a heavy-tie and sentinel table (3 words) split unevenly, and runs
     of 0 and 1 rows;
  8. the A/B entry point ``krisp_tpu_torch.tools.ab_merge_path.run`` at
     its default 2 x 20M keys, 5 reps, with the merge's launch counter
     reset just before: arm B must equal arm A bit for bit;
  9. the out-of-core path through the CLI at 5 x 1 Mb on the spacer,
     amplicon and IUPAC genomes of phases 4-6, with 100 kb chunks and
     passes of 200,000 rows: the staged CUDA, staged CPU and fused CUDA
     runs write equal, non-empty bytes, and the unfiltered staged groups
     equal the planted answer;
 10. the out-of-core path at full size, 5 x 40 Mb spacer 25/1/2 (16 Mb
     chunks, the default 2 GiB passes), all through the CLI with equal CSV
     bytes: fused as the card's default budget routes it (no global pass;
     one warm-up, 2 timed runs), staged as krisp_tpu's budget routes it
     (KRISP_TPU_HBM_BUDGET=8589934592 named; 1 run, no temporary table
     directory left), ``--workdir`` cold (1 run) and warm (2 runs); the
     window-key, sort and scan kernels must have launched in the staged
     runs;
 11. kstream (``krisp_tpu_torch.cli.kstream`` and ``kstream_fast``) on one
     synthetic genome (``synth_kstream_genome``: random bases as
     ``synth_genomes`` draws them, 8 contigs, assembly gaps of N and
     soft-masked stretches; inputs without a softmask flag get its upper
     case copy, since lower case sends them to the string pipeline), every
     sorted with ``--disallow Nn``:
       a. at 1 Mb through the CLI with ``--engine device``, CUDA bytes ==
          CPU bytes (and == ``--engine host`` for k <= 64) for k 28
          ``--canonicals``, k 28 ``--complements --omit-softmask``, k 100
          ``--map-softmask`` and (200 kb) k 512 ``--canonicals``; on 200 kb
          k 28 and k 100 CUDA bytes == the port's string pipeline;
       b. at 40 Mb, ``run_fast_kstream`` into a hashing sink: k 28
          ``--canonicals`` on the device engine and on the host engine
          (equal sha256 and lines), and k 100 ``--complements`` as ``auto``
          routes it (the device engine, one shot), held to invariants in
          torch ops (lines == 2 x valid windows, the pulled unique table
          strictly increasing, its counts summing to the lines); k 28:
          one warm-up run, best of 3, and the card's busy share from a
          profiler trace of one run; k 100: one run (8 GB of text);
          stage split and peak device memory; the
          window-key and sort kernels at these shapes against their plain
          versions;
       c. at 2 Mb, k 28 ``--canonicals`` under KRISP_TPU_HBM_BUDGET=
          36000000 (segmented, 4 segments): bytes == one shot == host
          engine.
     Every device-engine run on the card must return a count (no
     out-of-memory fallback) and launch both kernels.
 12. krisp_vcf (``krisp_tpu_torch.cli.krisp_vcf``; the classifier is torch
     ops, no hand kernel: each entry point counts the batches it runs on
     the card, and every CUDA run below must have counted some):
       a. the CLI on a fuzz-style VCF (``tests/test_vcf_fuzz.py``'s recipe,
          two contigs, about 2,100 records x 8 samples) and on the
          dense-indel VCF: ``--engine device`` on CUDA and CPU and
          ``--engine host`` write equal, non-empty bytes, and so do
          ``--vcf -`` on CUDA and on the CPU (on the one-contig VCF, the
          file routes' bytes too: a stream scans every contig as one run,
          so on two contigs krisp_tpu's windows differ as well);
       b. the classifier alone at cohort scale (500 samples, 8 alleles, 4
          groups; 32,768 rows on the small pull, 4,096 on the full
          layout and ``classify_batch``), exact against the numpy mirror,
          timed; bound: the bytes uploaded and pulled;
       c. ``tools/bench_vcf_scaled.py``'s 100,000 records x 100 samples
          with ``--index``: the device engine on CUDA best of 3 (variants/s,
          stage split, peak device memory, a traced run's busy share) and
          once on the CPU, equal bytes; a 10,000-record ``--pos`` slice on
          CUDA, the CPU and the host engine, equal bytes.  The four
          kernels' launches in these runs are recorded (``vcf_launches``).
 13. the multi-device paths on this one card, as virtual shards: a mesh
     ``[cuda:0] * n`` whose n shards each run the real kernels and exchange
     rows by device copies (``krisp_tpu_torch.parallel``); every run below
     zeroes the launch counters just before and reads them just after:
       a. the sharded search through ``run_pipeline(mesh=...)`` on phases
          4-5's 5 x 4 Mb spacer and amplicon genomes at n = 1-4: the
          unfiltered survivor groups and the CSV bytes equal the
          single-device run's, and the window-key, sort, merge (n > 1: one
          shard has nothing to merge) and scan kernels launched; then
          phase 10's 5 x 40 Mb spacer on 4 shards once, timed, with peak
          device memory, CSV bytes equal to phase 10's; every run routed by
          the card's default budget, its peak within 4 (n) shards' charge;
       b. kstream k 28 ``--canonicals`` on the 40 Mb genome over 4 shards
          (``kstream_device._run_sharded``): sha256 equal to phase 11 b's
          device engine;
       c. the classifier on 32,768 x 500 x 8, 4 groups, sharded by variants
          and by samples on 2 and 4 shards: exact against one device;
       d. a one-rank NCCL process group (``multihost.init_runtime``,
          ``pod_mesh``) carrying the process-group transport of the spacer
          search at 5 x 1 Mb, kstream on 1 Mb and the classifier on 4,096 x
          500 (both axes), each equal to one device's; destroyed after;
       e. ``krisp_fasta --profile-dir`` at 5 x 1 Mb spacer: the bytes of a
          run without it, and a trace whose kernel events name the
          window-key, sort and scan kernels.
     Scaling across cards is not measured here: the machine has one.
 14. the device-memory routing (``krisp_tpu_torch/budget.py``) with
     KRISP_TPU_HBM_BUDGET unset: the card's budget (free memory less the
     reserve); for the spacer, amplicon and IUPAC layouts at 5 x 4, 16 and
     40 Mb a ``run_pipeline`` routed fused by that budget whose peak device
     memory is within ``fused_charge``, and the extraction's own peak
     (``genome_key_tables``); the same for one spacer and one IUPAC genome
     of 40 Mb (every row survives: the device part alone); the reserve:
     each of those two, a whole ``run_pipeline`` of the amplicon layout at
     5 x 4 Mb and of the spacer at 5 x 40 Mb, the amplicon layout at
     5 x 4 Mb on 4 virtual shards and kstream's stage at 40 Mb, k 28
     complements, each in a new process whose card is filled but for its
     charge plus the reserve, which must route it to the one-device route
     and finish; the spacer at
     5 x 100 Mb (about 1.0e9 rows, near the 2**31-row guard),
     fused, its unfiltered groups equal to the planted answer; the routing
     on synthetic sizes, nothing allocated: 5 x 40 Mb of each layout
     fused, 600 Mb + 9 x 1 Mb and a table just past 2**31 rows staged (the
     latter by the row guard alone), a bucket under it fused, and the
     amplicon layout on both sides of the budget's edge; kstream's one-shot
     stage on the 40 Mb genome at k 12, 28 and 100 in three modes within
     its charge, and a sort past the row guard segmented.
Then a ``details`` line with every measurement as JSON, one JSON line of
per-kernel results (each with its least time ``bound_ms``: the bytes its
inputs and outputs hold once, over the card's 3.35 TB/s), the
``nvidia-smi`` name/power line, and, last, ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import gzip
import hashlib
import json
import os
import resource
import shutil
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
SMALL, LARGE, FULL = 1_000_000, 4_000_000, 40_000_000
IUPAC_EVERY = 100_000
AB_N = 20_000_000
#: kstream inputs: one genome (phase 11 b) and slices of it (a, c)
KS_FULL, KS_SMALL, KS_SLICE, KS_SEG = 40_000_000, 1_000_000, 200_000, 2_000_000
KS_SEG_BUDGET = 36_000_000
#: krisp_tpu's KRISP_TPU_HBM_BUDGET default (8 GiB), named where a run
#: takes the staged path as krisp_tpu routes it
KRISP_TPU_BUDGET = 8589934592
#: krisp_vcf inputs (phase 12): the fuzz-style VCF's seed and contig length
#: (two contigs, about 2,100 records), the scaled bench's records and
#: samples and its slice, the cohort batches (rows on the small pull, rows
#: on the full layout, samples, alleles, groups)
VCF_SEED, VCF_FUZZ_LEN = 11, 60_000
VCF_SCALED, VCF_SLICE_RECORDS = (100_000, 100), 10_000
VCF_COHORT = (32_768, 4_096, 500, 8, 4)
#: phase 13: virtual shard counts on one card, and the count at 40 Mb
SHARDS, SHARD_FULL = (1, 2, 3, 4), 4
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3, published


def bound_ms(n_bytes):
    """The least time for moving ``n_bytes`` at the card's peak rate."""
    return n_bytes / PEAK_BYTES_PER_S * 1e3


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


def busy_by_kernel(fn, reps=5):
    """The card's busy time of one call of ``fn`` in ms (kernels, memsets
    and copies, host gaps left out) from a profiler trace of ``reps``
    calls after one warm-up call, and that time by kernel:
    {first 40 characters of the name: ms a call}.  A trace that holds no
    device event at all (the profiler now and then returns one empty) is
    taken again, up to three times; if all three are empty the busy time
    is not measured: (None, {})."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by_kernel = {}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                by_kernel[e.key[:40]] = (by_kernel.get(e.key[:40], 0.0)
                                         + e.self_device_time_total / reps
                                         / 1e3)
        busy = sum(by_kernel.values())
        if busy > 0:
            return busy, by_kernel
    print("chip_smoke: the profiler saw no device time in three traces; "
          "busy time not measured", flush=True)
    return None, {}


def busy_ms(fn, reps=5):
    """``busy_by_kernel``'s total alone."""
    return busy_by_kernel(fn, reps)[0]


def fmt(x, spec):
    """``x`` formatted with ``spec``, or "not measured" for None."""
    return "not measured" if x is None else format(x, spec)


def timed(fn, reps=5):
    """(ms, busy ms) of one call of ``fn``: ``cuda_ms`` and ``busy_ms``."""
    return cuda_ms(fn, reps), busy_ms(fn, reps)


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
    """The kernel wrappers by name; each counts its launches.  The
    window-key kernel has two: its TPU mode and its table mode; so has the
    survivor scan: its valid-array mode and its layout mode."""
    from krisp_tpu_torch.ops.merge import merge_sorted_words
    from krisp_tpu_torch.ops.pack import window_keys_both, window_keys_table
    from krisp_tpu_torch.ops.scan import survivor_scan, survivor_scan_layout
    from krisp_tpu_torch.ops.sort import sort_words
    return {"window_keys_both": window_keys_both,
            "window_keys_table": window_keys_table, "sort_words": sort_words,
            "survivor_scan": survivor_scan,
            "survivor_scan_layout": survivor_scan_layout,
            "merge_sorted_words": merge_sorted_words}


def reset_launches():
    for fn in kernel_wrappers().values():
        fn.launches = 0


def launch_counts():
    """Launches per kernel (each kernel's two modes together)."""
    w = kernel_wrappers()
    counts = {k: fn.launches for k, fn in w.items()
              if k not in ("window_keys_table", "survivor_scan_layout")}
    counts["window_keys_both"] += w["window_keys_table"].launches
    counts["survivor_scan"] += w["survivor_scan_layout"].launches
    return counts


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
    check(sources == ["merge_words.cu", "sort_words.cu", "survivor_scan.cu",
                      "window_keys.cu"], f"expected four kernel sources: "
          f"{sources}")
    check(lib.krisp_survivor_scan_block_rows() > 0
          and lib.krisp_survivor_scan_ahead_rows() > 0
          and lib.krisp_sort_words_block_rows() > 0
          and lib.krisp_window_keys_max_len() > 0
          and lib.krisp_merge_words_max_words() == 64
          and lib.krisp_merge_words_tile_rows(2) > 0, "kernel library broken")
    return dt


def phase_window_keys(dev, n_bytes):
    from krisp_tpu_torch.ops.encode import KeyLayout
    from krisp_tpu_torch.ops.pack import (window_keys_both,
                                          window_keys_both_reference,
                                          window_keys_table,
                                          window_keys_table_reference)
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
            ms, busy = timed(lambda: window_keys_both(*args))
            plain_ms = cuda_ms(lambda: window_keys_both_reference(*args))
            # table mode into a column slice of a wider table (genome 2 of
            # N_FILES), as the pipeline's fused table takes it
            n_win, W = int(ok.numel()), got[1].shape[0]
            targs = (b, 2, *geom, N_FILES, omit)
            wide = torch.full((W, N_FILES * 2 * n_win), 7, dtype=torch.int32,
                              device=dev)
            cols = slice(2 * 2 * n_win, 3 * 2 * n_win)
            window_keys_table(*targs, out=wide[:, cols])
            want_t = window_keys_table_reference(*targs)
            torch.cuda.synchronize()
            err_t = max_abs_err([wide[:, cols]], [want_t])
            check(err_t == 0 and int((wide == 7).sum()) ==
                  W * (N_FILES - 1) * 2 * n_win,
                  f"window table mode differs at {geom} omit={omit}")
            del want_t
            table_ms, table_busy = timed(
                lambda: window_keys_table(*targs, out=wide[:, cols]))
            table_plain_ms = cuda_ms(
                lambda: window_keys_table_reference(*targs))
            del wide
            assert W == KeyLayout(*geom, 2, N_FILES).n_words
            results.append(dict(
                geom=list(geom), omit_soft=omit, n_win=n_win,
                valid=int(ok.sum()), max_abs_err=max(err, err_t), ms=ms,
                busy_ms=busy, plain_ms=plain_ms,
                bound_ms=bound_ms(n_bytes + n_win * (1 + 8 * W)),
                table_ms=table_ms, table_busy_ms=table_busy,
                table_plain_ms=table_plain_ms,
                table_bound_ms=bound_ms(n_bytes + n_win * 8 * W)))
            print(f"phase 2 window_keys {geom} omit_soft={omit}: exact, "
                  f"kernel {ms:.4f} ms ({fmt(busy, '.4f')} busy), plain "
                  f"{plain_ms:.3f} ms; table mode kernel {table_ms:.4f} ms "
                  f"({fmt(table_busy, '.4f')} busy), plain "
                  f"{table_plain_ms:.3f} "
                  "ms; "
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


def _fused_key(table):
    """Keys of up to 2 words as one int64 whose signed order is the rows'
    unsigned order (``ops/sort.py:_group64``'s digit)."""
    bias = -(1 << 31)
    if table.shape[0] == 1:
        return table[0] ^ bias
    return (((table[0] ^ bias).to(torch.int64) << 32)
            | (table[1].to(torch.int64) & 0xFFFFFFFF))


def _or_rows(x):
    """Per word, the OR over the rows of int32[V, n], folded on the card."""
    if x.shape[1] == 0:
        return [0] * x.shape[0]
    while x.shape[1] > 1:
        h = x.shape[1] // 2
        y = x[:, :h] | x[:, h:2 * h]
        if x.shape[1] % 2:
            y[:, 0] |= x[:, -1]
        x = y
    return [int(v) & 0xFFFFFFFF for v in x[:, 0].tolist()]


def _sort_passes(table):
    """The sort kernel's passes on ``table``: its plan from a torch fold of
    the rows that are not all ones (what the kernel's vary_kernel folds)."""
    from krisp_tpu_torch.ops.sort import sort_pass_plan, varying_masks
    sent = (table == -1).all(dim=0)
    rest = table[:, ~sent]
    flags = int(bool(sent.any())) | 2 * int(rest.shape[1] > 0)
    return len(sort_pass_plan(varying_masks(_or_rows(rest), _or_rows(~rest),
                                            flags)))


def _check_sort(name, table):
    from krisp_tpu_torch.ops.sort import sort_words, sort_words_reference
    got = sort_words(table)
    want = sort_words_reference(table)
    torch.cuda.synchronize()
    err = max_abs_err([got], [want])
    check(err == 0 and torch.equal(got, want),
          f"sort kernel differs from its plain version on {name}")
    del got, want
    ms, busy = timed(lambda: sort_words(table))
    plain_ms = cuda_ms(lambda: sort_words_reference(table))
    V, n = table.shape
    library_ms = None
    if V <= 2:
        key = _fused_key(table)
        library_ms = cuda_ms(lambda: torch.sort(key))
        del key
    passes = _sort_passes(table)
    print(f"phase 3 sort_words {name}: {n} rows x {V} words, exact, "
          f"{passes} passes, kernel {ms:.3f} ms ({fmt(busy, '.3f')} busy), "
          "plain (torch.sort passes) "
          f"{plain_ms:.3f} ms, one torch.sort of the fused key "
          f"{library_ms if library_ms is None else f'{library_ms:.3f}'} ms",
          flush=True)
    return dict(table=name, rows=n, words=V, passes=passes,
                max_abs_err=err, ms=ms, busy_ms=busy, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms(8 * V * n))


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


def _boundary_table(dev, tile, ahead, reps=330):
    """A spacer-layout table whose flank groups end where the scan
    kernel's tiles and look-ahead do: groups of a tile, a tile +- 1, the
    look-ahead and one or two rows more, tiny groups and groups of several
    tiles, repeated, so that groups start at every offset of a tile
    (about 10M rows at a 4,096-row tile).  Keys as the pipeline makes
    them: flank (the group number in word 0), genome id (some sentinel)
    and a random mid; bits below the mid 0."""
    from krisp_tpu_torch.ops.encode import KeyLayout
    rng = np.random.default_rng(SEED + 2)
    layout = KeyLayout(*SPACER, 2, N_FILES)
    check(layout.n_words == 2, "the boundary table takes 2-word keys")
    sizes = np.tile([tile - 1, ahead, ahead + 1, tile, 1, 2, 3, tile // 2,
                     5 * tile + 7, ahead + 2, 1, tile + 1], reps)
    n = int(sizes.sum())
    group = np.repeat(np.arange(sizes.size, dtype=np.uint32), sizes)
    fw, fsh = layout.file_word_shift()
    ids = rng.integers(0, N_FILES, n).astype(np.uint32)
    ids[rng.random(n) < 0.05] = layout.file_sentinel
    mid_shift = 32 * layout.n_words - layout.total_bits
    mid = rng.integers(0, 4, n).astype(np.uint32) << np.uint32(mid_shift)
    words = np.stack([group, (ids << np.uint32(fsh)) | mid])
    check(fw == 1, "the spacer layout's genome id lies in word 1")
    words = np.ascontiguousarray(words[:, np.lexsort(tuple(words[::-1]))])
    return layout, torch.from_numpy(words.view(np.int32)).to(dev)


def phase_scan(dev, scan_tables):
    """The survivor-scan kernel in both modes (validity from the keys, as
    the pipeline calls it, and from an array) vs its plain version on each
    path's sorted table (2, 4 and 7 words), on a table of long runs and on
    a table of groups that end on the kernel's tile and look-ahead edges:
    keep, counts and gid exact, with median CUDA-event times of both and
    the busy time of each mode split by kernel."""
    from krisp_tpu_torch.kernels import build
    from krisp_tpu_torch.ops.scan import (survivor_scan, survivor_scan_layout,
                                          survivor_scan_layout_reference,
                                          survivor_scan_reference, valid_rows)
    from krisp_tpu_torch.tools.kernel_times import long_runs_table

    lib = build.load_library()
    tables = dict(scan_tables)
    w, layout = long_runs_table(np.random.default_rng(SEED), 10_000_017,
                                dev)
    tables["long_runs"] = (layout, w)
    tables["tile_boundaries"] = _boundary_table(
        dev, lib.krisp_survivor_scan_block_rows(),
        lib.krisp_survivor_scan_ahead_rows())
    results = []
    for name, (layout, w) in tables.items():
        v = valid_rows(w, layout)
        args = (w, v, layout.flank_bits, layout.file_off + layout.file_bits,
                N_FILES)
        largs = (w, layout, N_FILES)
        want = survivor_scan_layout_reference(*largs)
        errs = []
        for mode, got in (("layout", survivor_scan_layout(*largs)),
                          ("valid", survivor_scan(*args))):
            torch.cuda.synchronize()
            for g, r, what in zip(got, want, ("keep", "counts", "gid")):
                check(g.dtype == r.dtype and torch.equal(g, r),
                      f"survivor scan ({mode} mode) {what} differs on {name}")
            errs.append(max_abs_err(got, want))
            del got
        n_keep = int(want[0].sum())
        check(n_keep > 0, f"no survivor in {name}")
        del want
        ms = cuda_ms(lambda: survivor_scan_layout(*largs))
        busy, by_kernel = busy_by_kernel(lambda: survivor_scan_layout(*largs))
        plain_ms = cuda_ms(lambda: survivor_scan_layout_reference(*largs))
        valid_ms = cuda_ms(lambda: survivor_scan(*args))
        valid_busy, valid_by_kernel = busy_by_kernel(
            lambda: survivor_scan(*args))
        valid_plain_ms = cuda_ms(lambda: survivor_scan_reference(*args))
        W, n = w.shape
        # in: W words a row (and the valid byte in array mode); out: keep
        # (1 byte), counts and gid (4 bytes each) a row
        results.append(dict(
            table=name, rows=n, words=W, n_keep=n_keep,
            max_abs_err=max(errs), ms=ms, busy_ms=busy, by_kernel=by_kernel,
            plain_ms=plain_ms, bound_ms=bound_ms(n * (4 * W + 9)),
            valid_mode_ms=valid_ms, valid_mode_busy_ms=valid_busy,
            valid_mode_by_kernel=valid_by_kernel,
            valid_mode_plain_ms=valid_plain_ms,
            valid_mode_bound_ms=bound_ms(n * (4 * W + 10))))
        split = ", ".join(f"{k} {v:.4f}" for k, v in by_kernel.items())
        print(f"phase 3 survivor_scan {name}: {n} rows x {W} words, exact "
              f"in both modes, {n_keep} survivors; layout mode kernel "
              f"{ms:.3f} ms ({fmt(busy, '.4f')} busy: {split}), plain "
              f"{plain_ms:.3f} ms; valid mode kernel {valid_ms:.3f} ms "
              f"({fmt(valid_busy, '.4f')} busy), plain {valid_plain_ms:.3f} "
              "ms",
              flush=True)
        del v
    return results


def _geom_flags(geom):
    if geom == AMPLICON:
        return ["--conserved", str(geom[0]), "--amplicon", str(sum(geom))]
    return ["--conserved-left", str(geom[0]), "--conserved-right",
            str(geom[2]), "--diagnostic", str(geom[1])]


def _cli(paths, geom, device, out_dir: Path, flags=(), name=None):
    from krisp_tpu_torch.cli.krisp_fasta import main
    name = name or device
    csv, align = out_dir / f"{name}.csv", out_dir / f"{name}.txt"
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
    reset_launches()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        _cli(paths_l, geom, "cuda", out_dir, variants[0])
        times.append(time.perf_counter() - t0)
    launches = launch_counts()
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


def _check_merge(name, a, b, time_it=True):
    """The merge kernel vs its plain version on two sorted runs."""
    from krisp_tpu_torch.ops.merge import (merge_sorted_words,
                                           merge_sorted_words_reference)
    got = merge_sorted_words(a, b)
    want = merge_sorted_words_reference(a, b)
    torch.cuda.synchronize()
    err = max_abs_err([got], [want])
    check(err == 0 and torch.equal(got, want),
          f"merge kernel differs from its plain version on {name}")
    del got, want
    ms = busy = plain_ms = library_ms = None
    V = a.shape[0]
    if time_it:
        ms, busy = timed(lambda: merge_sorted_words(a, b))
        plain_ms = cuda_ms(lambda: merge_sorted_words_reference(a, b))
        if V <= 2:   # one torch.sort of both runs' fused keys
            key = _fused_key(torch.cat([a, b], dim=1))
            library_ms = cuda_ms(lambda: torch.sort(key))
            del key
    n_bytes = 2 * 4 * V * (a.shape[1] + b.shape[1])   # both runs in, out
    print(f"phase 7 merge_sorted_words {name}: {a.shape[1]} + {b.shape[1]} "
          f"rows x {V} words, exact"
          + (f", kernel {ms:.3f} ms, plain (sort of both) {plain_ms:.3f} ms"
             if time_it else "")
          + (f", one torch.sort of the fused keys {library_ms:.3f} ms"
             if library_ms is not None else ""), flush=True)
    return dict(table=name, rows_a=a.shape[1], rows_b=b.shape[1], words=V,
                max_abs_err=err, ms=ms, busy_ms=busy, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms(n_bytes))


def _split_sorted(flat, cut):
    from krisp_tpu_torch.ops.sort import sort_words
    return sort_words(flat[:, :cut]), sort_words(flat[:, cut:])


def phase_merge(dev, spacer, amplicon):
    """The merge kernel on the A/B halves, on the spacer and amplicon
    tables of genomes 0-2 and 3-4 sorted apart, on an uneven tie table and
    on runs of 0 and 1 rows."""
    from krisp_tpu_torch.convert import keys_from_numpy
    from krisp_tpu_torch.tools.ab_merge_path import ab_keys

    results = []
    words = keys_from_numpy(ab_keys(AB_N), dev)
    results.append(_check_merge("ab_halves", *_split_sorted(words, AB_N)))
    del words
    for name, paths, geom in (("spacer_path_genomes_012_34", spacer, SPACER),
                              ("amplicon_path_genomes_012_34", amplicon,
                               AMPLICON)):
        _, flat = _key_table(paths, geom, dev)
        cut = flat.shape[1] // N_FILES * 3      # genome tables are equal
        runs = _split_sorted(flat, cut)
        del flat
        results.append(_check_merge(name, *runs))
        del runs
    ties = _tie_table(dev, 3, 10_000_019)
    results.append(_check_merge("ties_sentinels_uneven",
                                *_split_sorted(ties, 2_345_678)))
    del ties
    one = _tie_table(dev, 2, 1001)
    for na, nb in ((0, 0), (0, 1), (1, 0), (1, 1), (0, 1000), (1, 1000),
                   (1000, 1)):
        a, b = _split_sorted(one[:, :na + nb], na)
        results.append(_check_merge(f"runs_{na}_{nb}", a, b, time_it=False))
    return results


def phase_ab(dev):
    """The A/B entry point at the JAX tool's defaults; the merge's launches
    counted over this run only."""
    from krisp_tpu_torch.tools.ab_merge_path import run
    reset_launches()
    out = run(n=AB_N, reps=5, device=dev)
    out["launches"] = launch_counts()["merge_sorted_words"]
    print("phase 8 ab_merge_path " + json.dumps(out), flush=True)
    check(out["bit_parity"] is True, "A/B: arm B differs from arm A")
    check(out["launches"] > 0, "A/B: the merge kernel never launched")
    return out


def _set_env(**env):
    """Set (or, for None, unset) environment variables; returns the old
    values for ``_set_env(**old)``."""
    old = {k: os.environ.get(k) for k in env}
    for k, v in env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = str(v)
    return old


def phase_out_of_core_small(dev, genomes, td):
    """Staged CUDA == staged CPU == fused CUDA bytes at 5 x 1 Mb with 100 kb
    chunks and 200,000-row passes; unfiltered staged groups == planted."""
    from krisp_tpu_torch.engine.pipeline import KmerGeometry, run_pipeline
    from krisp_tpu_torch.metrics import GLOBAL as METRICS

    results = {}
    old = _set_env(KRISP_TPU_CHUNK_BASES=100_000,
                      KRISP_TPU_GLOBAL_ROWS=200_000)
    for name, geom, flags in (("spacer", SPACER, ()),
                              ("amplicon", AMPLICON, ()),
                              ("iupac", SPACER, ("--dot-alignment",))):
        (paths, planted), _ = genomes[name]
        out_dir = td / f"ooc_{name}"
        out_dir.mkdir()
        outs, secs = {}, {}
        for run_name, device, wd in (("staged_cuda", "cuda", "wd_cuda"),
                                     ("staged_cpu", "cpu", "wd_cpu"),
                                     ("fused_cuda", "cuda", None)):
            METRICS.reset()
            extra = ("--workdir", str(out_dir / wd)) if wd else ()
            t0 = time.perf_counter()
            outs[run_name] = _cli(paths, geom, device, out_dir,
                                  (*flags, *extra), name=run_name)
            secs[run_name] = time.perf_counter() - t0
            if wd:
                passes = METRICS.stages["global_pass"].calls
        check(outs["staged_cuda"] == outs["staged_cpu"] == outs["fused_cuda"],
              f"out-of-core {name}: staged CUDA, staged CPU and fused CUDA "
              "bytes differ at 5 x 1 Mb")
        csv_rows = outs["staged_cuda"][0].count(b"\n") - 1
        check(csv_rows > 0 and len(outs["staged_cuda"][1]) > 0,
              f"out-of-core {name}: no CSV row at 5 x 1 Mb")
        groups = _groups_as_dict(run_pipeline(
            paths[:2], paths[2:], KmerGeometry(*geom), ingroup_filter=False,
            workdir=str(out_dir / "wd_unfiltered"), device=dev))
        want = _planted_groups(planted, geom)
        check(groups == want, f"out-of-core {name}: staged groups {groups} "
              f"!= planted {want}")
        check(passes >= 24, f"out-of-core {name}: only {passes} passes")
        results[name] = dict(csv_rows=csv_rows, passes=passes, seconds=secs,
                             planted_groups=len(want))
        print(f"phase 9 out-of-core {name} 5 x 1 Mb: staged CUDA "
              f"({secs['staged_cuda']:.2f} s) == staged CPU "
              f"({secs['staged_cpu']:.2f} s) == fused CUDA "
              f"({secs['fused_cuda']:.2f} s), {csv_rows} CSV rows, {passes} "
              f"passes, {len(want)} planted groups found", flush=True)
    _set_env(**old)
    return results


def _tables_dirs():
    return set(Path(tempfile.gettempdir()).glob("krisp_tpu_tables_*"))


def phase_out_of_core_full(dev, td):
    """5 x 40 Mb spacer through the CLI: fused as the card's default budget
    routes it, staged as krisp_tpu's 8 GiB budget routes it, ``--workdir``
    cold and warm; equal CSV bytes everywhere."""
    from krisp_tpu_torch.metrics import GLOBAL as METRICS

    t0 = time.perf_counter()
    paths, _ = synth_genomes(td / "spacer_40mb", FULL, SPACER)
    synth_s = time.perf_counter() - t0
    free = shutil.disk_usage(td).free
    print(f"phase 10 out-of-core 5 x 40 Mb: genomes written in {synth_s:.1f} "
          f"s, {free / 2**30:.1f} GiB free on disk", flush=True)
    out_dir = td / "ooc_full"
    out_dir.mkdir()
    workdir = td / "ooc_full_tables"
    n_keys = N_FILES * 2 * (FULL - sum(SPACER) + 1)
    old = _set_env(KRISP_TPU_CHUNK_BASES=16 << 20,
                      KRISP_TPU_GLOBAL_ROWS=None, KRISP_TPU_GLOBAL_BYTES=None)
    runs = {}
    csv_ref = None
    staged_launches = dict.fromkeys(launch_counts(), 0)

    def run_kind(kind, n_runs, flags=(), budget=None, warmup=False):
        nonlocal csv_ref
        env = _set_env(KRISP_TPU_HBM_BUDGET=budget)
        if warmup:
            _cli(paths, SPACER, "cuda", out_dir, flags, name=kind)
        METRICS.reset()
        reset_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        before = _tables_dirs()
        times = []
        for _ in range(n_runs):
            t = time.perf_counter()
            csv, _ = _cli(paths, SPACER, "cuda", out_dir, flags, name=kind)
            times.append(time.perf_counter() - t)
            csv_ref = csv_ref if csv_ref is not None else csv
            check(csv == csv_ref and csv.count(b"\n") > 1,
                  f"out-of-core 5 x 40 Mb: {kind} CSV differs or is empty")
        left = _tables_dirs() - before
        _set_env(**env)
        launches = launch_counts()
        stages = {k: v.seconds / n_runs for k, v in METRICS.stages.items()}
        gp = METRICS.stages.get("global_pass")
        res = dict(times_s=times, kmers_per_s=n_keys / min(times),
                   stages_s=stages, launches=launches,
                   passes=gp.calls // n_runs if gp else None,
                   global_rows=gp.items // n_runs if gp else None,
                   peak_bytes=torch.cuda.max_memory_allocated(dev),
                   tables_dirs_left=len(left))
        if kind != "fused":
            for k, v in launches.items():
                staged_launches[k] += v
        print(f"phase 10 out-of-core {kind}: runs "
              f"{[round(t, 3) for t in times]} s, "
              f"{res['kmers_per_s']:,.0f} k-mers/s (best), passes "
              f"{res['passes']}, rows {res['global_rows']}, peak device "
              f"memory {res['peak_bytes'] / 2**20:.1f} MiB, launches "
              f"{launches}", flush=True)
        print(f"phase 10 out-of-core {kind} stages (mean s per run): "
              + ", ".join(f"{k} {v:.4f}" for k, v in stages.items()),
              flush=True)
        runs[kind] = res
        return res

    fused = run_kind("fused", 2, warmup=True)
    check(fused["passes"] is None and "pull" in fused["stages_s"],
          "out-of-core: the card's default budget did not route 5 x 40 Mb "
          "fused")
    routed = run_kind("staged_routed", 1, budget=KRISP_TPU_BUDGET)
    check(routed["passes"] and routed["passes"] >= 2,
          f"out-of-core: krisp_tpu's budget did not route 5 x 40 Mb staged "
          f"in several passes ({routed['passes']})")
    check(routed["tables_dirs_left"] == 0,
          "out-of-core: a krisp_tpu_tables_* directory was left behind")
    run_kind("workdir_cold", 1, ("--workdir", str(workdir)))
    warm = run_kind("workdir_warm", 2, ("--workdir", str(workdir)))
    check("extract+sort" not in warm["stages_s"],
          "out-of-core: the warm run rebuilt a cached table")
    check(all(staged_launches[k] > 0 for k in
              ("window_keys_both", "sort_words", "survivor_scan")),
          f"out-of-core: a kernel never launched in the staged runs: "
          f"{staged_launches}")
    cache_bytes = sum(f.stat().st_size for f in workdir.iterdir())
    shutil.rmtree(workdir)
    _set_env(**old)
    host_peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    print(f"phase 10 out-of-core: cache {cache_bytes / 2**30:.2f} GiB, host "
          f"peak RSS {host_peak / 2**30:.2f} GiB, staged launches "
          f"{staged_launches}", flush=True)
    return dict(runs=runs, n_keys=n_keys, synth_s=synth_s,
                cache_bytes=cache_bytes, host_peak_rss_bytes=host_peak,
                staged_launches=staged_launches, disk_free_bytes=free,
                csv_sha256=hashlib.sha256(csv_ref).hexdigest(),
                paths=paths)


def synth_kstream_genome(size):
    """One genome for kstream: random A/C/G/T bases drawn as
    ``synth_genomes`` draws them (seed 7), then assembly gaps (50 runs of
    1-200 N a Mb) and soft-masked stretches (100 runs of 50-2,000 bases a
    Mb, lower case; a gap inside one becomes n).  Returns uint8[size]."""
    rng = np.random.default_rng(SEED)
    seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=size)

    def runs(n, lo, hi):
        starts = rng.integers(0, size - hi, n)
        mark = np.zeros(size + 1, np.int32)
        np.add.at(mark, starts, 1)
        np.add.at(mark, starts + rng.integers(lo, hi, n), -1)
        return np.cumsum(mark[:-1]) > 0

    seq[runs(size // 20_000, 1, 200)] = ord("N")
    seq[runs(size // 10_000, 50, 2000)] |= 0x20
    return seq


def write_kstream_fasta(path: Path, seq, n_records):
    """``seq`` as ``n_records`` contigs of 80-column lines."""
    with open(path, "wb") as fh:
        for i, rec in enumerate(np.array_split(seq, n_records)):
            fh.write(f">contig_{i}\n".encode())
            full = rec.size // 80 * 80
            body = np.empty((full // 80, 81), np.uint8)
            body[:, :80] = rec[:full].reshape(-1, 80)
            body[:, 80] = ord("\n")
            fh.write(body.tobytes())
            if rec.size > full:
                fh.write(rec[full:].tobytes() + b"\n")
    return path


class HashSink:
    """A binary stream that keeps only the sha256, lines and bytes of what
    it is written."""

    def __init__(self):
        self.sha, self.lines, self.bytes = hashlib.sha256(), 0, 0

    def write(self, data):
        data = data if isinstance(data, bytes) else bytes(data)
        self.sha.update(data)
        self.lines += data.count(b"\n")
        self.bytes += len(data)
        return len(data)

    def flush(self):
        pass


def _device_engine_run(what, fn, on_card=True):
    """``fn()`` with the launch counters zeroed just before: on the card,
    both kstream kernels must have launched (a device out-of-memory error
    raises).  Returns (fn's result, launches)."""
    reset_launches()
    res = fn()
    launches = launch_counts()
    if on_card:
        check(launches["window_keys_both"] > 0 and launches["sort_words"] > 0,
              f"kstream {what}: a kernel never launched: {launches}")
    return res, launches


def _kstream_cli(path, flags, engine, device, out: Path):
    from krisp_tpu_torch.cli.kstream import main
    rc = main([str(path), *flags, "--disallow", "Nn", "--sort", "--engine",
               engine, "--device", device, "--output", str(out)])
    check(rc == 0, f"kstream exit {rc} ({flags}, {engine}, {device})")
    return out.read_bytes()


def kstream_inputs(td: Path):
    """The genome and its slices as FASTA files: {name: path}."""
    t0 = time.perf_counter()
    seq = synth_kstream_genome(KS_FULL)
    upper = seq & np.uint8(0xDF)
    files = {}
    for name, data, n_rec in (("40mb_upper", upper, 8),
                              ("2mb_upper", upper[:KS_SEG], 4),
                              ("1mb_upper", upper[:KS_SMALL], 4),
                              ("1mb_soft", seq[:KS_SMALL], 4),
                              ("200kb_upper", upper[:KS_SLICE], 2),
                              ("200kb_soft", seq[:KS_SLICE], 2)):
        files[name] = write_kstream_fasta(td / f"kstream_{name}.fasta", data,
                                          n_rec)
    print(f"phase 11 kstream: inputs written in "
          f"{time.perf_counter() - t0:.1f} s; soft-masked "
          f"{float(np.mean(seq >= ord('a'))):.3f}, N "
          f"{float(np.mean(upper == ord('N'))):.4f} of the bases",
          flush=True)
    return files


def phase_kstream_small(td: Path, files):
    """(a): CUDA == CPU (== host engine for k <= 64) through the CLI at
    1 Mb (k 512 at 200 kb); CUDA == the string pipeline at 200 kb."""
    from krisp_tpu_torch.kstream import KStream
    out = td / "kstream_out"
    out.mkdir()
    results = []
    for name, path, flags in (
            ("k28_canonicals", files["1mb_upper"], ["-k", "28",
                                                    "--canonicals"]),
            ("k28_complements_omit", files["1mb_soft"],
             ["-k", "28", "--complements", "--omit-softmask"]),
            ("k100_map", files["1mb_soft"], ["-k", "100", "--map-softmask"]),
            ("k512_canonicals", files["200kb_upper"],
             ["-k", "512", "--canonicals"])):
        k = int(flags[1])
        t0 = time.perf_counter()
        cuda, launches = _device_engine_run(name, lambda: _kstream_cli(
            path, flags, "device", "cuda", out / f"{name}_cuda.txt"))
        t_cuda = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu, _ = _device_engine_run(name, lambda: _kstream_cli(
            path, flags, "device", "cpu", out / f"{name}_cpu.txt"), False)
        t_cpu = time.perf_counter() - t0
        lines = cuda.count(b"\n")
        check(cuda == cpu and lines > 0,
              f"kstream {name}: CUDA and CPU bytes differ or are empty")
        host = None
        if k <= 64:
            host = _kstream_cli(path, flags, "host", "cuda",
                                out / f"{name}_host.txt")
            check(host == cuda, f"kstream {name}: device and host engine "
                  "bytes differ")
        results.append(dict(name=name, input=path.name, lines=lines,
                            cuda_s=t_cuda, cpu_s=t_cpu, launches=launches,
                            host_equal=None if host is None else True))
        print(f"phase 11a kstream {name} ({path.name}): CUDA ({t_cuda:.2f} "
              f"s) == CPU ({t_cpu:.2f} s)"
              + (" == host engine" if host is not None else "")
              + f", {lines} lines, launches {launches}", flush=True)
        for f in out.iterdir():
            f.unlink()
    for name, path, flags, kwargs in (
            ("k28_canonicals", files["200kb_upper"],
             ["-k", "28", "--canonicals"], dict(kmers=[28], canonicals=True)),
            ("k100_map", files["200kb_soft"], ["-k", "100", "--map-softmask"],
             dict(kmers=[100], mapsoft=True))):
        cuda, _ = _device_engine_run(name, lambda: _kstream_cli(
            path, flags, "device", "cuda", out / f"{name}_slice.txt"))
        t0 = time.perf_counter()
        want = "".join(line + "\n" for line in KStream(
            disallow="Nn", sort=True, **kwargs)(str(path))).encode()
        t_str = time.perf_counter() - t0
        check(cuda == want and len(want) > 0,
              f"kstream {name}: CUDA bytes differ from the string pipeline "
              "at 200 kb")
        results.append(dict(name=f"{name}_string_pipeline",
                            input=path.name, lines=want.count(b"\n"),
                            string_pipeline_s=t_str))
        print(f"phase 11a kstream {name} ({path.name}): CUDA == string "
              f"pipeline ({t_str:.2f} s), {results[-1]['lines']} lines",
              flush=True)
    shutil.rmtree(out)
    return results


def _valid_windows(padded, k, dev):
    """Windows of k A/C/G/T bases (either case) of the padded buffer,
    counted in torch ops on the card."""
    b = torch.from_numpy(padded).to(dev).to(torch.int32)
    up = b & 0xDF
    bad = ~((up == 65) | (up == 67) | (up == 71) | (up == 84))
    c = torch.cat([bad.new_zeros(1, dtype=torch.int64),
                   torch.cumsum(bad.to(torch.int64), 0)])
    return int(((c[k:] - c[:-k]) == 0).sum())


def _strictly_increasing(words_h, dev):
    """Rows of uint32[W, n] strictly increasing in unsigned lexicographic
    order, checked in torch ops on the card."""
    bias = -(1 << 31)
    x = torch.from_numpy(np.ascontiguousarray(words_h).view(np.int32)).to(dev)
    lt = torch.zeros(x.shape[1] - 1, dtype=torch.bool, device=dev)
    eq = torch.ones_like(lt)
    for w in x:
        a, b = w[:-1] ^ bias, w[1:] ^ bias
        lt |= eq & (a < b)
        eq &= a == b
    return bool(lt.all())


def _kstream_kernels(dev, padded, k, mode):
    """The window-key and sort kernels at one of phase 11b's shapes (the
    padded 40 Mb buffer) against their plain versions, exact, with median
    CUDA-event times; bound: each input and output byte once at the card's
    peak rate."""
    from krisp_tpu_torch.kstream_device import mode_keys
    from krisp_tpu_torch.ops.pack import (window_keys_both,
                                          window_keys_both_reference)
    from krisp_tpu_torch.ops.sort import sort_words, sort_words_reference
    b = torch.from_numpy(padded).to(dev)
    args = (b, k, 0, 0, 2, 1, False)
    ok, fwd, rc = window_keys_both(*args)
    want = window_keys_both_reference(*args)
    torch.cuda.synchronize()
    check(torch.equal(ok, want[0]), f"kstream k {k}: window ok differs")
    err_w = max_abs_err([fwd, rc], want[1:], rows=ok)
    del want
    check(err_w == 0, f"kstream k {k}: window words differ")
    n_win, W = ok.numel(), fwd.shape[0]
    win = dict(k=k, n_win=n_win, words=W, max_abs_err=err_w,
               ms=cuda_ms(lambda: window_keys_both(*args)),
               plain_ms=cuda_ms(lambda: window_keys_both_reference(*args)),
               bound_ms=bound_ms(padded.size + n_win * (1 + 8 * W)))
    table, _ = mode_keys(ok, fwd, rc, mode)
    del ok, fwd, rc
    got = sort_words(table)
    want = sort_words_reference(table)
    torch.cuda.synchronize()
    err_s = max_abs_err([got], [want])
    check(err_s == 0, f"kstream k {k} {mode}: the sort kernel differs")
    del got, want
    V, n = table.shape
    srt = dict(k=k, mode=mode, rows=n, words=V, max_abs_err=err_s,
               ms=cuda_ms(lambda: sort_words(table)),
               plain_ms=cuda_ms(lambda: sort_words_reference(table), reps=3),
               bound_ms=bound_ms(8 * V * n))
    del table
    torch.cuda.empty_cache()
    print(f"phase 11b kstream kernels k {k} {mode}: window keys "
          f"{n_win} x {W} exact, {win['ms']:.3f} ms (plain "
          f"{win['plain_ms']:.3f}); sort {n} x {V} exact, {srt['ms']:.3f} ms "
          f"(plain {srt['plain_ms']:.3f})", flush=True)
    return win, srt


def phase_kstream_full(dev, files, k100_runs=1):
    """(b): 40 Mb, k 28 canonicals on both engines (one warm-up each, best
    of 3, the card's busy time from a trace of one more device run) and
    k 100 complements under auto (best of ``k100_runs``; the k 28 runs
    warmed the engine up), with their invariants."""
    from krisp_tpu_torch.budget import device_budget, kstream_card_bytes
    from krisp_tpu_torch.io.fasta import bucket_size, load_buffer
    from krisp_tpu_torch.kstream_device import (_run_stage, device_plan,
                                                kstream_route)
    from krisp_tpu_torch import kstream_vec
    from krisp_tpu_torch.kstream_fast import run_fast_kstream
    from krisp_tpu_torch.metrics import GLOBAL as METRICS
    path = files["40mb_upper"]
    results = {}

    def timed_runs(name, plan, engine, n_runs=3, warm=True, trace=False):
        def one():
            sink = HashSink()
            t = time.perf_counter()
            n = run_fast_kstream(str(path), plan, sink, engine=engine,
                                 device=dev)
            dt = time.perf_counter() - t
            check(n is not None and n == sink.lines,
                  f"kstream {name}: returned {n}, wrote {sink.lines} lines")
            return dt, sink

        device = engine != "host"
        if warm:
            one()
        METRICS.reset()
        torch.cuda.reset_peak_memory_stats(dev)
        (runs, launches) = _device_engine_run(
            name, lambda: [one() for _ in range(n_runs)]) if device else (
            [one() for _ in range(n_runs)], None)
        times = [dt for dt, _ in runs]
        sinks = {(s.sha.hexdigest(), s.lines) for _, s in runs}
        check(len(sinks) == 1, f"kstream {name}: runs differ")
        sha, lines = sinks.pop()
        res = dict(times_s=times, best_s=min(times), lines=lines,
                   bytes=runs[0][1].bytes, sha256=sha,
                   kmers_per_s=lines / min(times))
        if device:
            res.update(stages_s={k: v.seconds / n_runs
                                 for k, v in METRICS.stages.items()},
                       launches=launches,
                       launches_per_run={k: v / n_runs for k, v in
                                         launches.items()},
                       peak_bytes=torch.cuda.max_memory_allocated(dev))
        if trace:
            busy = busy_by_kernel(one, reps=1)[0]   # one more run, traced
            res.update(busy_ms=busy, busy_share=None if busy is None
                       else busy / 1e3 / min(times))
        results[name] = res
        print(f"phase 11b kstream {name}: runs "
              f"{[round(t, 3) for t in times]} s, {lines} lines, "
              f"{res['kmers_per_s']:,.0f} k-mers/s (best)"
              + (f", peak device memory {res['peak_bytes'] / 2**20:.1f} "
                 f"MiB, launches {launches}" if device else "")
              + (f", card busy {fmt(res['busy_ms'], '.1f')} ms a run"
                 + (f" ({100 * res['busy_share']:.2f}% of the best)"
                    if res["busy_share"] is not None else "")
                 if trace else ""), flush=True)
        if device:
            print(f"phase 11b kstream {name} stages (mean s per run): "
                  + ", ".join(f"{k} {v:.4f}"
                              for k, v in res["stages_s"].items()),
                  flush=True)
        return res

    k28 = device_plan(kmers=28, canonicals=True, disallow="Nn", sort=True)
    dev_res = timed_runs("k28_canonicals_device", k28, "device", trace=True)
    # the host engine's figure is the native core's: without it the engine
    # would run its numpy mirror, another engine
    check(kstream_vec._load_core() is not None
          and os.environ.get("KRISP_TPU_KSTREAM_HOST") != "numpy",
          "kstream: the host engine's native core did not build or load")
    host_res = timed_runs("k28_canonicals_host", k28, "host")
    host_res["core"] = dict(name="native",
                            threads=kstream_vec._core_threads(KS_FULL - 27))
    print(f"phase 11b kstream k28_canonicals_host ran the native core, "
          f"{host_res['core']['threads']} threads", flush=True)
    check(dev_res["sha256"] == host_res["sha256"]
          and dev_res["lines"] == host_res["lines"] > 0,
          "kstream 40 Mb k 28: device and host engine outputs differ")
    results["device_over_host_s"] = dev_res["best_s"] / host_res["best_s"]

    k100 = device_plan(kmers=100, complements=True, disallow="Nn", sort=True)
    buf = load_buffer(str(path))
    padded = np.zeros(bucket_size(buf.size), np.uint8)   # as the engine pads
    padded[:buf.size] = buf
    del buf
    est = padded.size * kstream_card_bytes(100, "complements")
    check(kstream_route(padded.size, 100, "complements", device_budget(dev))
          == "one_shot", "kstream k 100: not routed one shot")
    res = timed_runs("k100_complements_auto", k100, "auto", k100_runs,
                     warm=False)
    res["est_bytes"] = est
    valid = _valid_windows(padded, 100, dev)
    words_h, reps, n_unique = _run_stage(padded, k100, dev)   # the table
    check(res["lines"] == 2 * valid,
          f"kstream k 100: {res['lines']} lines, {valid} valid windows")
    check(int(reps.sum()) == res["lines"] and int(reps.min()) >= 1,
          "kstream k 100: the table's counts do not sum to the lines")
    check(_strictly_increasing(words_h, dev),
          "kstream k 100: the pulled unique table is not strictly increasing")
    res.update(valid_windows=valid, n_unique=n_unique)
    print(f"phase 11b kstream k100_complements_auto: {valid} valid windows, "
          f"{n_unique} unique rows strictly increasing, counts sum to the "
          f"{res['lines']} lines", flush=True)
    del words_h, reps
    torch.cuda.empty_cache()

    kernels = [_kstream_kernels(dev, padded, 28, "canonicals"),
               _kstream_kernels(dev, padded, 100, "complements")]
    results["kernels"] = dict(window_keys_both=[w for w, _ in kernels],
                              sort_words=[s for _, s in kernels])
    return results


def phase_kstream_segmented(td: Path, files):
    """(c): 2 Mb, k 28 canonicals under a 36 MB budget (4 segments) through
    the CLI: bytes == the one-shot run == the host engine."""
    from krisp_tpu_torch.metrics import GLOBAL as METRICS
    path, flags = files["2mb_upper"], ["-k", "28", "--canonicals"]
    out = td / "kstream_seg"
    out.mkdir()
    one, _ = _device_engine_run("2 Mb one shot", lambda: _kstream_cli(
        path, flags, "device", "cuda", out / "one.txt"))
    old = _set_env(KRISP_TPU_HBM_BUDGET=KS_SEG_BUDGET)
    METRICS.reset()
    t0 = time.perf_counter()
    seg, launches = _device_engine_run("2 Mb segmented", lambda: _kstream_cli(
        path, flags, "device", "cuda", out / "seg.txt"))
    seg_s = time.perf_counter() - t0
    _set_env(**old)
    segments = METRICS.stages["upload"].calls
    host = _kstream_cli(path, flags, "host", "cuda", out / "host.txt")
    check(segments >= 4, f"kstream segmented: {segments} segments")
    check(seg == one == host and len(seg) > 0,
          "kstream 2 Mb: segmented, one-shot and host engine bytes differ")
    shutil.rmtree(out)
    lines = seg.count(b"\n")
    print(f"phase 11c kstream segmented 2 Mb k 28 canonicals: {segments} "
          f"segments ({seg_s:.2f} s) == one shot == host engine, {lines} "
          f"lines, launches {launches}", flush=True)
    return dict(segments=segments, seconds=seg_s, lines=lines,
                launches=launches)


VCF_GROUPS = {"EU1": ["e1", "e2", "e3", "e4"], "NA1": ["n1", "n2", "n3", "n4"]}
VCF_SAMPLES = [s for ss in VCF_GROUPS.values() for s in ss]
VCF_HEADER = ("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER"
              "\tINFO\tFORMAT\t")


def _vcf_meta(path: Path, groups):
    path.write_text("sample_id,group\n" + "".join(
        f"{s},{g}\n" for g, ss in groups.items() for s in ss))
    return str(path)


def _vcf_reference(path: Path, seqs):
    with open(path, "w") as fh:
        for c, seq in seqs.items():
            fh.write(f">{c}\n")
            for i in range(0, len(seq), 70):
                fh.write(seq[i:i + 70] + "\n")
    return str(path)


def synth_vcf_fuzz(td: Path, seed, contigs=("ctg1", "ctg2"),
                   contig_len=VCF_FUZZ_LEN):
    """``tests/test_vcf_fuzz.py``'s ``synth_fuzz_inputs`` recipe (indels,
    multiallelics, missing calls, failing DP gates, low QUAL and MQ, 8
    samples in 2 groups) over several contigs, with one change: at EU1's
    fixed-ALT sites NA1 calls REF (the test's recipe calls het there, so
    no window can be diagnostic).  Returns (meta, reference, vcf.gz)."""
    td.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    meta = _vcf_meta(td / "meta.csv", VCF_GROUPS)
    seqs = {c: "".join(rng.choice(list("ACGT"), size=contig_len))
            for c in contigs}
    ref = _vcf_reference(td / "ref.fasta", seqs)
    lines = []
    for c, seq in seqs.items():
        pos = 60
        while pos < contig_len - 200:
            ref_len = int(rng.choice([1, 1, 1, 2, 3]))
            ref_allele = seq[pos - 1:pos - 1 + ref_len]
            n_alts = int(rng.choice([1, 1, 1, 2]))
            alts = []
            while len(alts) < n_alts:
                alt_len = int(rng.choice([1, 1, ref_len, ref_len + 1,
                                          max(1, ref_len - 1)]))
                a = "".join(rng.choice(list("ACGT"), size=alt_len))
                if a != ref_allele and a not in alts:
                    alts.append(a)
            qual = int(rng.choice([900, 900, 900, 5]))
            mq = int(rng.choice([60, 60, 60, 10]))
            scenario = rng.random()
            cols = []
            for g, ss in VCF_GROUPS.items():
                for _ in ss:
                    r = rng.random()
                    if r < 0.08:
                        cols.append("./.:.:.:.")
                    elif r < 0.14:
                        cols.append("0/0:" + ",".join(["4"] + ["0"] * n_alts)
                                    + ":4:99")
                    elif scenario < 0.35 and g == "EU1":
                        ad = ["0"] * (1 + n_alts)
                        ad[1] = "48"
                        cols.append(f"1/1:{','.join(ad)}:48:99")
                    elif 0.35 <= scenario < 0.45:
                        ad = ["25", "25"] + ["0"] * (n_alts - 1)
                        cols.append(f"0/1:{','.join(ad)}:50:99")
                    else:
                        cols.append("0/0:" + ",".join(["50"] + ["0"] * n_alts)
                                    + ":50:99")
            lines.append(f"{c}\t{pos}\t.\t{ref_allele}\t{','.join(alts)}\t"
                         f"{qual}\tPASS\tMQ={mq}\tGT:AD:DP:GQ\t"
                         + "\t".join(cols) + "\n")
            pos += int(rng.integers(25, 90))
    vcf = td / "vars.vcf.gz"
    with gzip.open(vcf, "wt") as fh:
        fh.write(VCF_HEADER + "\t".join(VCF_SAMPLES) + "\n")
        fh.writelines(lines)
    return meta, ref, str(vcf)


def synth_vcf_dense(td: Path, seed):
    """``tests/test_vcf_fuzz.py``'s ``synth_dense_inputs``: variants 2-13
    bases apart with overlapping reference spans (the alignment's
    overlapping-indel text).  Returns (meta, reference, vcf.gz)."""
    td.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    meta = _vcf_meta(td / "meta.csv", VCF_GROUPS)
    contig_len = 2500
    seq = "".join(rng.choice(list("ACGT"), size=contig_len))
    ref = _vcf_reference(td / "ref.fasta", {"ctg1": seq})
    lines = []
    pos = 50
    while pos < contig_len - 150:
        ref_len = int(rng.choice([1, 2, 3, 4]))
        ref_allele = seq[pos - 1:pos - 1 + ref_len]
        alt = "".join(rng.choice(list("ACGT"),
                                 size=int(rng.choice([1, 2, ref_len + 2]))))
        if alt == ref_allele:
            alt = alt + "A"
        scenario = rng.random()
        cols = ["1/1:0,48:48:99" if scenario < 0.4 and g == "EU1"
                else "0/0:50,0:50:99"
                for g, ss in VCF_GROUPS.items() for _ in ss]
        lines.append(f"ctg1\t{pos}\t.\t{ref_allele}\t{alt}\t900\tPASS\tMQ=60"
                     "\tGT:AD:DP:GQ\t" + "\t".join(cols) + "\n")
        pos += int(rng.integers(2, 14))
    vcf = td / "vars.vcf.gz"
    with gzip.open(vcf, "wt") as fh:
        fh.write(VCF_HEADER + "\t".join(VCF_SAMPLES) + "\n")
        fh.writelines(lines)
    return meta, ref, str(vcf)


def synth_vcf_scaled(td: Path, n_records, n_samples, seed=0):
    """``tools/bench_vcf_scaled.py``'s ``synth_scaled`` (one contig, 4
    groups): 92.5% conserved REF, 0.5% one group fixed for an ALT (the
    diagnostic candidates), 3% het, 2.5% half the samples under the DP
    gate, 1.5% no data; 10% multiallelic, REF 1-3 bases, gaps 10-49.
    Returns (meta, reference, vcf.gz, planted (pos, group) pairs)."""
    td.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    n_groups = 4
    per = n_samples // n_groups
    groups = {f"G{g + 1}": [f"g{g + 1}s{i}" for i in range(per)]
              for g in range(n_groups)}
    meta = _vcf_meta(td / "meta.csv", groups)
    gaps = rng.integers(10, 50, n_records)
    pos = np.cumsum(gaps) + 50
    contig_len = int(pos[-1]) + 500
    seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), contig_len)
    ref = _vcf_reference(td / "ref.fasta", {"ctg1": seq.tobytes().decode()})

    def col(gt, ad, dp, gq):
        return f"{gt}:{ad}:{dp}:{gq}"

    homref = {1: col("0/0", "50,0", 50, 99), 2: col("0/0", "50,0,0", 50, 99)}
    homalt = {1: col("1/1", "0,48", 48, 99), 2: col("1/1", "0,48,0", 48, 99)}
    lowq = {1: col("0/0", "4,0", 4, 99), 2: col("0/0", "4,0,0", 4, 99)}
    het = {1: col("0/1", "25,25", 50, 99), 2: col("0/1", "25,25,0", 50, 99)}
    scen = rng.random(n_records)
    n_alts_arr = np.where(rng.random(n_records) < 0.1, 2, 1)
    ref_len = rng.choice([1, 1, 1, 1, 1, 1, 2, 3], n_records)
    diag_group = rng.integers(0, n_groups, n_records)
    alt_base = {0: "A", 1: "C", 2: "G", 3: "T"}
    join_homref = {na: "\t".join([homref[na]] * n_samples) for na in (1, 2)}
    join_het = {na: "\t".join([het[na]] * n_samples) for na in (1, 2)}
    join_lowq = {na: "\t".join([lowq[na]] * (n_samples // 2)
                               + [homref[na]] * (n_samples - n_samples // 2))
                 for na in (1, 2)}
    join_miss = "\t".join(["./.:.:.:."] * n_samples)
    join_diag = {(g, na): "\t".join(
        sum(([homalt[na] if gi == g else homref[na]] * per
             for gi in range(n_groups)), []))
        for g in range(n_groups) for na in (1, 2)}
    planted = []
    vcf = td / "vars.vcf.gz"
    with gzip.open(vcf, "wt", compresslevel=1) as fh:
        fh.write(VCF_HEADER + "\t".join(s for ss in groups.values()
                                        for s in ss) + "\n")
        for i in range(n_records):
            p = int(pos[i])
            rl = int(ref_len[i])
            ref_allele = seq[p - 1:p - 1 + rl].tobytes().decode()
            na = int(n_alts_arr[i])
            alts = []
            while len(alts) < na:
                a = alt_base[rng.integers(0, 4)] * (1 if rl == 1 else
                                                    int(rng.integers(1, 4)))
                if a != ref_allele and a not in alts:
                    alts.append(a)
            s = scen[i]
            if s < 0.925:
                joined = join_homref[na]
            elif s < 0.930:
                g = int(diag_group[i])
                joined = join_diag[(g, na)]
                planted.append((p, g))
            elif s < 0.96:
                joined = join_het[na]
            elif s < 0.985:
                joined = join_lowq[na]
            else:
                joined = join_miss
            fh.write(f"ctg1\t{p}\t.\t{ref_allele}\t{','.join(alts)}\t900\t"
                     f"PASS\tMQ=60\tGT:AD:DP:GQ\t{joined}\n")
    return meta, ref, str(vcf), planted, list(groups)


def vcf_cohort_batch(seed, V, S, A, G):
    """``classify_batch``'s arrays for V records x S samples x A alleles in
    G equal groups, in the scaled bench's mix (``tests/torch_vcf_inputs.py``
    holds the same recipe): most records REF in every group, 20% with one
    group fixed for an ALT, 10% with mixed or het calls, some under the DP
    gate, missing or of low quality."""
    rng = np.random.default_rng(seed)
    group_id = (np.arange(S) * G // S).astype(np.int32)
    n_alleles = rng.integers(2, A + 1, V).astype(np.int32)
    kind = rng.random(V)
    fixed = np.zeros((V, G), np.int64)
    diag = kind < 0.2
    fixed[diag, rng.integers(0, G, diag.sum())] = rng.integers(
        1, n_alleles[diag])
    allele = fixed[:, group_id]
    noisy = (kind >= 0.2) & (kind < 0.3)
    mixed = noisy[:, None] & (rng.random((V, S)) < 0.3)
    allele = np.where(mixed, rng.integers(0, n_alleles[:, None], (V, S)),
                      allele)
    depth = rng.integers(12, 60, (V, S)).astype(np.int32)
    ad = np.zeros((V, S, A), np.int32)
    np.put_along_axis(ad, allele[:, :, None], depth[:, :, None], axis=2)
    het = noisy[:, None] & (rng.random((V, S)) < 0.2)
    ad[het, 0] += depth[het] // 2
    dp = ad.sum(axis=2, dtype=np.int32)
    gq = rng.integers(45, 99, (V, S)).astype(np.int32)
    low = ((kind >= 0.3) & (kind < 0.35))[:, None] & (rng.random((V, S))
                                                      < 0.5)
    dp[low] = 4
    miss = ((kind >= 0.35) & (kind < 0.38))[:, None] | (rng.random((V, S))
                                                        < 0.001)
    dp[miss] = -1
    gq[miss] = -1
    ad[miss] = 0
    mq = np.where(rng.random(V) < 0.03, 10, 60).astype(np.float32)
    qual = np.where(rng.random(V) < 0.03, 5, 900).astype(np.float32)
    return dict(dp=dp, gq=gq, ad=ad, n_alleles=n_alleles, mq=mq, qual=qual,
                group_id=group_id,
                group_sizes=np.bincount(group_id, minlength=G)
                .astype(np.int32))


def vcf_classifiers():
    """The classifier's three entry points; each counts the batches it ran
    on a card in ``.launches``."""
    from krisp_tpu_torch.ops import vcfclass as vc
    return {"classify_batch": vc.classify_batch,
            "classify_batch_packed": vc.classify_batch_packed,
            "classify_bits_packed_small": vc.classify_bits_packed_small}


def reset_vcf_counts():
    for fn in vcf_classifiers().values():
        fn.launches = 0


def vcf_counts():
    return {k: fn.launches for k, fn in vcf_classifiers().items()}


def _vcf_cli(argv, stdin=None):
    """``krisp_tpu_torch.cli.krisp_vcf.main(argv)``, with ``stdin`` (a plain
    VCF file) as standard input where given; wall seconds."""
    from krisp_tpu_torch.cli.krisp_vcf import main
    old = sys.stdin
    t0 = time.perf_counter()
    try:
        if stdin is not None:
            sys.stdin = open(stdin)
        rc = main([str(a) for a in argv])
    finally:
        if stdin is not None:
            sys.stdin.close()
        sys.stdin = old
    dt = time.perf_counter() - t0
    check(rc == 0, f"krisp_vcf exit {rc} ({argv[2:]})")
    return dt


def _vcf_bytes(out: Path, tag):
    return ((out / f"{tag}.csv").read_bytes(),
            (out / f"{tag}.align.txt").read_bytes())


def phase_vcf_small(td: Path):
    """12 a: the CLI on the fuzz-style two-contig VCF and the dense-indel
    VCF: ``--engine device`` on CUDA and on the CPU and ``--engine host``
    write equal, non-empty CSV and alignment bytes; ``--vcf -`` (the
    streaming route) writes equal, non-empty bytes on CUDA and on the CPU
    (a stream is one scan over every contig, so on two contigs its windows
    may differ from the file routes', in krisp_tpu too: recorded; on the
    one-contig VCF the stream must write the file routes' bytes); both
    CUDA routes count classification batches, the others none."""
    results = []
    for name, n_contigs, (meta, ref, vcf) in (
            ("fuzz_2contig", 2, synth_vcf_fuzz(td / "vcf_fuzz", VCF_SEED)),
            ("dense_indels", 1, synth_vcf_dense(td / "vcf_dense", 700))):
        out = Path(vcf).parent
        plain = out / "vars.vcf"
        with gzip.open(vcf, "rb") as fh:
            plain.write_bytes(fh.read())
        n_records = sum(1 for line in plain.open() if line[0] != "#")
        base = [meta, ref, "--groups", "EU1", "NA1", "--min_samples", "3"]
        res = dict(name=name, records=n_records, samples=len(VCF_SAMPLES))
        outs = {}
        for tag, flags, stdin in (
                ("device_cuda", ["--vcf", vcf, "--engine", "device"], None),
                ("device_cpu", ["--vcf", vcf, "--engine", "device",
                                "--device", "cpu"], None),
                ("host", ["--vcf", vcf, "--engine", "host"], None),
                ("stdin_cuda", ["--engine", "device"], plain),
                ("stdin_cpu", ["--engine", "device", "--device", "cpu"],
                 plain)):
            reset_vcf_counts()
            res[f"{tag}_s"] = _vcf_cli(
                base + flags + ["--out_csv", out / f"{tag}.csv",
                                "--out_align", out / f"{tag}.align.txt"],
                stdin)
            counts = vcf_counts()
            if tag.endswith("cuda"):
                res[f"{tag}_batches"] = counts
            check((sum(counts.values()) > 0) == tag.endswith("cuda"),
                  f"krisp_vcf {name} {tag}: batches on the card {counts}")
            outs[tag] = _vcf_bytes(out, tag)
        rows = outs["host"][0].count(b"\n") - 1
        files = {outs[t] for t in ("device_cuda", "device_cpu", "host")}
        check(len(files) == 1 and rows >= 1 and len(outs["host"][1]) > 0,
              f"krisp_vcf {name}: file routes differ or wrote no row")
        check(outs["stdin_cuda"] == outs["stdin_cpu"]
              and outs["stdin_cuda"][0].count(b"\n") > 1,
              f"krisp_vcf {name}: the stdin route differs on CUDA and CPU")
        res.update(rows=rows, stdin_rows=outs["stdin_cuda"][0].count(b"\n")
                   - 1, stdin_equals_file=outs["stdin_cuda"] == outs["host"])
        # one contig shorter than a chunk: the stream and the file routes
        # scan the same records in one window run, so the bytes must agree
        check(n_contigs > 1 or res["stdin_equals_file"],
              f"krisp_vcf {name}: the stdin route differs from the file's")
        results.append(res)
        print(f"phase 12a krisp_vcf {name}: {n_records} records x "
              f"{len(VCF_SAMPLES)} samples; device CUDA "
              f"({res['device_cuda_s']:.2f} s) == device CPU "
              f"({res['device_cpu_s']:.2f} s) == host "
              f"({res['host_s']:.2f} s), {rows} rows; stdin CUDA "
              f"({res['stdin_cuda_s']:.2f} s) == stdin CPU, "
              f"{res['stdin_rows']} rows (== the file routes' bytes: "
              f"{res['stdin_equals_file']}); "
              f"batches on the card {res['device_cuda_batches']}, stdin "
              f"{res['stdin_cuda_batches']}", flush=True)
    return results


def phase_vcf_classifier(dev):
    """12 b: the classifier alone at cohort scale (500 samples, 8 alleles,
    4 groups): ``classify_bits_packed_small`` on 32,768 rows (the small
    pull), ``classify_batch_packed`` (the full layout) and
    ``classify_batch`` on 4,096, each exact against the numpy mirror on the
    same arrays; median CUDA-event ms, busy ms, the mirror's host ms; bound:
    the bytes uploaded and pulled at the card's peak rate."""
    from krisp_tpu_torch.ops import vcfclass as vc
    V_small, V_full, S, A, G = VCF_COHORT
    kw = dict(min_samples=3, min_reads=10, min_geno_qual=40, min_freq=0.1,
              min_map_qual=30, min_var_qual=10, min_samp_prop=0.9)
    small_kw = {k: kw[k] for k in ("min_samples", "min_map_qual",
                                   "min_var_qual", "min_samp_prop")}
    results = []
    for name, V in (("classify_bits_packed_small", V_small),
                    ("classify_batch_packed", V_full),
                    ("classify_batch", V_full)):
        arrays = vcf_cohort_batch(V, V, S, A, G)
        t0 = time.perf_counter()
        mirror = vc.classify_batch_packed_numpy(n_groups=G, **arrays, **kw)
        mirror_ms = (time.perf_counter() - t0) * 1e3
        res = dict(name=name, rows=V, samples=S, alleles=A, groups=G,
                   mirror_host_ms=mirror_ms)
        if name == "classify_bits_packed_small":
            t0 = time.perf_counter()
            bits = vc.host_gate_counted_bits(
                arrays["dp"], arrays["gq"], arrays["ad"],
                arrays["n_alleles"], kw["min_reads"], kw["min_geno_qual"],
                kw["min_freq"])
            res["host_masks_ms"] = (time.perf_counter() - t0) * 1e3
            up = dict(gate=bits[0], counted=bits[1], mq=arrays["mq"],
                      qual=arrays["qual"], group_id=arrays["group_id"],
                      group_sizes=arrays["group_sizes"])
            t = {k: torch.from_numpy(v).to(dev) for k, v in up.items()}

            def call():
                return vc.classify_bits_packed_small(
                    t["gate"], t["counted"], t["mq"], t["qual"],
                    t["group_id"], t["group_sizes"], n_groups=G,
                    n_samples=S, n_alleles=A, **small_kw)

            present = mirror[:, 3 * G:].reshape(V, G, A) > 0
            want = np.concatenate(
                [mirror[:, :3 * G], (present << np.arange(A)).sum(axis=2)],
                axis=1).astype(np.int16)
        else:
            up = arrays
            t = {k: torch.from_numpy(v).to(dev) for k, v in up.items()}
            want = mirror
            if name == "classify_batch_packed":
                def call():
                    return vc.classify_batch_packed(n_groups=G, **t, **kw)
            else:
                def call():
                    return vc.pack_outputs(
                        vc.classify_batch(n_groups=G, **t, **kw), V)
        reset_vcf_counts()
        got = call().cpu().numpy()
        check(vcf_counts()[name] == 1, f"vcf {name}: not counted once")
        err = int(np.abs(got.astype(np.int64) - want.astype(np.int64)).max())
        check(got.dtype == want.dtype and got.shape == want.shape
              and err == 0, f"vcf {name}: differs from the numpy mirror")
        check((want[:, G:3 * G] >= 0).any(), f"vcf {name}: no call made")
        up_bytes = sum(v.nbytes for v in up.values())
        res.update(max_abs_err=err, upload_bytes=up_bytes,
                   pull_bytes=got.nbytes,
                   ms=cuda_ms(call), busy_ms=busy_ms(call),
                   bound_ms=bound_ms(up_bytes + got.nbytes),
                   bound_by="bytes")
        del t
        torch.cuda.empty_cache()
        results.append(res)
        print(f"phase 12b vcf {name} {V} x {S} x {A}, {G} groups: exact vs "
              f"the numpy mirror, {res['ms']:.3f} ms (busy "
              f"{fmt(res['busy_ms'], '.3f')}), bound {res['bound_ms']:.4f} "
              f"ms ({up_bytes} B up, {got.nbytes} B down); mirror "
              f"{mirror_ms:.1f} ms on the host", flush=True)
    return results


def phase_vcf_full(dev, td: Path):
    """12 c: ``tools/bench_vcf_scaled.py``'s protocol at its full size,
    100,000 records x 100 samples, 4 groups, one contig, gzip VCF with
    ``--index``: ``--engine device`` on CUDA (one run writes the index
    sidecar, then best of 3 with the stage split, peak device memory and
    batch counts, then one profiler-traced run for the card's busy share),
    on the CPU once (equal bytes), and on a ``--pos`` slice of 10,000
    records on CUDA, the CPU and the host engine (equal bytes)."""
    from krisp_tpu_torch.metrics import GLOBAL as METRICS
    n_records, n_samples = VCF_SCALED
    t0 = time.perf_counter()
    meta, ref, vcf, planted, groups = synth_vcf_scaled(
        td / "vcf_scaled", n_records, n_samples)
    synth_s = time.perf_counter() - t0
    out = Path(vcf).parent
    side = out / "vars.idx"
    base = [meta, ref, "--vcf", vcf, "--groups", *groups, "--min_samples",
            "3", "--index", side]

    def run(tag, flags=(), device="cuda"):
        return _vcf_cli(base + [*flags, "--device", device, "--out_csv",
                                out / f"{tag}.csv"])

    res = dict(records=n_records, samples=n_samples, groups=len(groups),
               planted=len(planted), synth_s=synth_s)
    res["cold_s"] = run("cold", ["--engine", "device"])    # writes the index
    check(side.exists(), "vcf: the index sidecar was not written")
    METRICS.reset()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_vcf_counts()
    reset_launches()
    times = [run(f"cuda{i}", ["--engine", "device"]) for i in range(3)]
    res["launches"] = launch_counts()
    res["batches"] = vcf_counts()
    check(sum(res["batches"].values()) > 0,
          "vcf 100k x 100: no classification batch ran on the card")
    res.update(times_s=times, best_s=min(times),
               variants_per_s=n_records / min(times),
               stages_s={k: v.seconds / 3 for k, v in METRICS.stages.items()},
               stage_calls={k: v.calls / 3 for k, v in METRICS.stages.items()},
               peak_bytes=torch.cuda.max_memory_allocated(dev))
    cuda = (out / "cuda0.csv").read_bytes()
    check(all((out / f"cuda{i}.csv").read_bytes() == cuda for i in (1, 2))
          and (out / "cold.csv").read_bytes() == cuda,
          "vcf 100k x 100: CUDA runs differ")
    rows = cuda.count(b"\n") - 1
    res["cpu_s"] = run("cpu", ["--engine", "device"], "cpu")
    check((out / "cpu.csv").read_bytes() == cuda and rows > 0,
          "vcf 100k x 100: CUDA and CPU bytes differ or no row")
    res["cpu_variants_per_s"] = n_records / res["cpu_s"]
    busy = busy_by_kernel(lambda: run("traced", ["--engine", "device"]),
                          reps=1)[0]
    res.update(busy_ms=busy, busy_share=None if busy is None
               else busy / 1e3 / res["best_s"], rows=rows)
    # the bench's slice: about 10,000 records (average gap 30)
    pos = ["--pos", "1", str(VCF_SLICE_RECORDS * 30 + 50)]
    res["slice_s"] = {tag: run(f"slice_{tag}", [*pos, "--engine", engine],
                               device)
                      for tag, engine, device in (
                          ("device_cuda", "device", "cuda"),
                          ("device_cpu", "device", "cpu"),
                          ("host", "host", "cuda"))}
    sl = {tag: (out / f"slice_{tag}.csv").read_bytes()
          for tag in res["slice_s"]}
    slice_rows = sl["host"].count(b"\n") - 1
    check(len(set(sl.values())) == 1 and slice_rows > 0,
          "vcf slice: CUDA, CPU and host engine bytes differ or no row")
    res.update(slice_rows=slice_rows,
               slice_records=VCF_SLICE_RECORDS)
    print(f"phase 12c krisp_vcf {n_records} x {n_samples}, 4 groups "
          f"(written in {synth_s:.1f} s, {len(planted)} planted): cold "
          f"{res['cold_s']:.2f} s, runs {[round(x, 3) for x in times]} s, "
          f"{res['variants_per_s']:,.0f} variants/s (best), {rows} rows; "
          f"CPU {res['cpu_s']:.2f} s ({res['cpu_variants_per_s']:,.0f} "
          f"variants/s), equal bytes; peak device memory "
          f"{res['peak_bytes'] / 2**20:.1f} MiB; card busy "
          f"{fmt(busy, '.1f')} ms a run"
          + (f" ({100 * res['busy_share']:.2f}% of the best)"
             if res["busy_share"] is not None else "")
          + f"; batches {res['batches']}, kernel launches {res['launches']}",
          flush=True)
    print("phase 12c krisp_vcf stages (mean s per run): "
          + ", ".join(f"{k} {v:.4f}" for k, v in res["stages_s"].items()),
          flush=True)
    print(f"phase 12c krisp_vcf slice ({VCF_SLICE_RECORDS} records): "
          + ", ".join(f"{k} {v:.2f} s" for k, v in res["slice_s"].items())
          + f", equal bytes, {slice_rows} rows", flush=True)
    shutil.rmtree(out)
    return res


# ---------------------------------------------------------------------------
# phase 13: the multi-device paths on one card (virtual shards)
# ---------------------------------------------------------------------------

#: the sharded paths' kernels; the merge kernel joins the runs a shard
#: receives, so one shard (nothing to merge) launches none
SHARDED_KERNELS = ("window_keys_both", "sort_words", "merge_sorted_words",
                   "survivor_scan")


def card_mesh(dev, n):
    """n virtual shards, all on ``dev``: each runs the real kernels and the
    shards exchange rows by device copies."""
    from krisp_tpu_torch.parallel.distributed import make_mesh
    return make_mesh(devices=[dev] * n)


def _csv_bytes(groups):
    """What the CLI writes to ``--out_csv`` for ``groups`` (no primer3)."""
    from krisp_tpu_torch.engine import render
    return (render.csv_header(primer3=False) + "\n" + "".join(
        render.render_csv(g) + "\n" for g in groups)).encode()


def _shard_charge(paths, geom, n):
    """The bytes the routing charges one card for ``n`` virtual shards of
    the search over ``paths``: n times a shard's charge."""
    from krisp_tpu_torch.engine.pipeline import fused_charge
    sizes, layout = _sizes_layout(paths, geom)
    return n * fused_charge(sizes, layout, sum(geom), n)[1]


def _sharded_run(dev, paths, geom, mesh, kernels, what):
    """One ``run_pipeline`` over ``mesh`` (routed by the card's default
    budget) without the ingroup filter, with the launch counters zeroed
    just before and read just after: (groups, wall s, launches, peak
    device bytes above what was allocated before).  Every kernel of
    ``kernels`` must have launched, and the peak must be within the
    routing's charge."""
    from krisp_tpu_torch.engine.pipeline import KmerGeometry, run_pipeline
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    t0 = time.perf_counter()
    groups = run_pipeline(paths[:2], paths[2:], KmerGeometry(*geom),
                          ingroup_filter=False, device=dev, mesh=mesh)
    dt = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) - base
    check(all(launches[k] > 0 for k in kernels),
          f"{what}: a kernel of the sharded path never launched: {launches}")
    charge = _shard_charge(paths, geom, mesh.size)
    check(peak <= charge, f"{what}: peak {peak} B over the charge {charge} B")
    return groups, dt, launches, peak


def phase_sharded_intersection(dev, genomes):
    """13 a: the sharded intersection on ``[cuda:0] * n``, n = 1-4, for the
    spacer and amplicon genomes of phases 4-5 at 5 x 4 Mb: the unfiltered
    groups (every survivor row: flank, mid, genome, count) equal the
    single-device run's, and the filtered run's CSV bytes too."""
    from krisp_tpu_torch.engine.pipeline import KmerGeometry, run_pipeline
    results = {}
    for name, geom in (("spacer", SPACER), ("amplicon", AMPLICON)):
        paths = genomes[name][1]
        g = KmerGeometry(*geom)
        one_groups = _groups_as_dict(run_pipeline(
            paths[:2], paths[2:], g, ingroup_filter=False, device=dev))
        one_csv = _csv_bytes(run_pipeline(paths[:2], paths[2:], g,
                                          device=dev))
        check(len(one_groups) > 0 and one_csv.count(b"\n") > 1,
              f"sharded {name}: the single-device run found nothing")
        for n in SHARDS:
            kernels = SHARDED_KERNELS if n > 1 else (
                "window_keys_both", "sort_words", "survivor_scan")
            groups, dt, launches, peak = _sharded_run(
                dev, paths, geom, card_mesh(dev, n), kernels,
                f"sharded {name} n {n}")
            check(_groups_as_dict(groups) == one_groups,
                  f"sharded {name} n {n}: survivor groups differ from one "
                  "device's")
            csv = _csv_bytes(run_pipeline(paths[:2], paths[2:], g,
                                          device=dev,
                                          mesh=card_mesh(dev, n)))
            check(csv == one_csv,
                  f"sharded {name} n {n}: CSV bytes differ from one device's")
            charge = _shard_charge(paths, geom, n)
            results[f"{name}_{n}"] = dict(
                shards=n, wall_s=dt, launches=launches, peak_bytes=peak,
                charge_bytes=charge, groups=len(one_groups),
                csv_rows=csv.count(b"\n") - 1)
            print(f"phase 13a sharded {name} 5 x 4 Mb on {n} virtual "
                  f"shard(s): groups and CSV == one device's, {dt:.3f} s, "
                  f"peak device memory {peak / 2**20:.1f} MiB (charge "
                  f"{charge / 2**20:.1f} MiB), launches {launches}",
                  flush=True)
    return results


def phase_sharded_full(dev, ooc_full):
    """13 a: 5 x 40 Mb spacer (phase 10's genomes) on 4 virtual shards,
    once, timed, with peak memory: CSV bytes == phase 10's."""
    from krisp_tpu_torch.engine.pipeline import KmerGeometry, run_pipeline
    paths = ooc_full["paths"]
    mesh = card_mesh(dev, SHARD_FULL)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    t0 = time.perf_counter()
    groups = run_pipeline(paths[:2], paths[2:], KmerGeometry(*SPACER),
                          device=dev, mesh=mesh)
    dt = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) - base
    charge = _shard_charge(paths, SPACER, SHARD_FULL)
    check(all(launches[k] > 0 for k in SHARDED_KERNELS),
          f"sharded 5 x 40 Mb: a kernel never launched (the card's default "
          f"budget must route it sharded): {launches}")
    check(peak <= charge,
          f"sharded 5 x 40 Mb: peak {peak} B over the charge {charge} B")
    sha = hashlib.sha256(_csv_bytes(groups)).hexdigest()
    check(sha == ooc_full["csv_sha256"],
          "sharded 5 x 40 Mb: CSV bytes differ from phase 10's")
    n_keys = N_FILES * 2 * (FULL - sum(SPACER) + 1)
    res = dict(shards=SHARD_FULL, wall_s=dt, kmers_per_s=n_keys / dt,
               launches=launches, peak_bytes=peak, charge_bytes=charge)
    print(f"phase 13a sharded spacer 5 x 40 Mb on {SHARD_FULL} virtual "
          f"shards: CSV == phase 10's, {dt:.3f} s, {n_keys / dt:,.0f} "
          f"k-mers/s, peak device memory {peak / 2**20:.1f} MiB (charge "
          f"{charge / 2**20:.1f} MiB), launches {launches}", flush=True)
    return res


def phase_sharded_kstream(dev, files, want_sha):
    """13 b: kstream k 28 ``--canonicals`` on the 40 Mb genome over 4
    virtual shards (``kstream_device._run_sharded``, the route of several
    cards): sha256 and lines == the device engine's (phase 11 b)."""
    from krisp_tpu_torch.io.fasta import load_buffer
    from krisp_tpu_torch.kstream_device import _run_sharded, device_plan
    plan = device_plan(kmers=28, canonicals=True, disallow="Nn", sort=True)
    buf = load_buffer(str(files["40mb_upper"]))
    sink = HashSink()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    n, launches = _device_engine_run(
        "sharded k 28", lambda: _run_sharded(buf, plan, sink,
                                             card_mesh(dev, SHARD_FULL)))
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    check(n == sink.lines > 0 and sink.sha.hexdigest() == want_sha,
          "sharded kstream k 28: output differs from the device engine's")
    res = dict(shards=SHARD_FULL, wall_s=dt, lines=n, launches=launches,
               peak_bytes=peak, kmers_per_s=n / dt)
    print(f"phase 13b sharded kstream 40 Mb k 28 canonicals on {SHARD_FULL} "
          f"virtual shards: sha256 == the device engine's, {n} lines, "
          f"{dt:.3f} s, peak device memory {peak / 2**20:.1f} MiB, launches "
          f"{launches}", flush=True)
    return res


def phase_sharded_vcf(dev):
    """13 c: the classifier at 32,768 x 500 x 8, 4 groups, sharded by
    variants and by samples on 2 and 4 virtual shards: exact against one
    device's ``classify_batch_packed``; median CUDA-event ms of each."""
    from krisp_tpu_torch.ops import vcfclass as vc
    from krisp_tpu_torch.parallel.vcf_shard import (
        classify_batch_packed_sharded)
    V, _, S, A, G = VCF_COHORT
    kw = dict(min_samples=3, min_reads=10, min_geno_qual=40, min_freq=0.1,
              min_map_qual=30, min_var_qual=10, min_samp_prop=0.9)
    arrays = vcf_cohort_batch(V, V, S, A, G)
    t = {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}
    want = vc.classify_batch_packed(n_groups=G, **t, **kw).cpu().numpy()
    results = dict(one_device_ms=cuda_ms(
        lambda: vc.classify_batch_packed(n_groups=G, **t, **kw), reps=3))
    del t
    for shard in ("variants", "samples"):
        for n in (2, 4):
            mesh = card_mesh(dev, n)

            def call():
                return classify_batch_packed_sharded(
                    mesh, **arrays, n_groups=G, shard=shard, **kw)

            got = call().cpu().numpy()
            err = int(np.abs(got.astype(np.int64) - want).max())
            check(got.dtype == want.dtype and err == 0,
                  f"sharded vcf {shard} n {n}: differs from one device's")
            ms = cuda_ms(call, reps=3)
            results[f"{shard}_{n}"] = dict(max_abs_err=err, ms=ms)
            print(f"phase 13c sharded vcf {V} x {S} x {A}, {G} groups, by "
                  f"{shard} on {n} virtual shards: exact vs one device, "
                  f"{ms:.1f} ms a call (uploads included; one device "
                  f"{results['one_device_ms']:.1f} ms, inputs on the card)",
                  flush=True)
            torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# phase 14: the device-memory budget and the routing's charges
# ---------------------------------------------------------------------------

#: the sizes each layout runs at (bases a genome, 5 genomes), and the
#: spacer's run near the row guard
BUDGET_SIZES = (LARGE, 16_000_000, FULL)
NEAR_GUARD = 100_000_000
#: the kstream stage's (k, mode) grid on the 40 Mb genome
KS_BUDGET_GRID = ((12, "complements"), (28, "complements"), (28, "plain"),
                  (28, "canonicals"), (100, "complements"),
                  (100, "canonicals"))


def _sizes_layout(paths, geom):
    """(genome sizes, KeyLayout) of the search over ``paths``, as
    ``run_pipeline`` reads them."""
    from krisp_tpu_torch.engine.pipeline import detect_bits
    from krisp_tpu_torch.io.fasta import load_buffer
    from krisp_tpu_torch.ops.encode import KeyLayout
    buffers = [load_buffer(p) for p in paths]
    return ([b.size for b in buffers],
            KeyLayout(*geom, detect_bits(buffers), len(paths)))


#: the reserve, tried at the edge: a new process fills the card but for
#: the charge of one run plus ``reserve`` bytes (the least free memory
#: under which the routing takes the one-device route), asks the routing
#: (``takes_fused``, ``kstream_route``) with the card's own budget
#: (``device_budget``, KRISP_TPU_HBM_BUDGET unset), which then reads what
#: the fill left, and runs it.  ``kind``: "device", the fused search's
#: device part (the table and the global stage, where every row survives
#: and the host decode alone would take minutes); "pipeline", the whole
#: ``run_pipeline``, which routes itself; "sharded", ``run_pipeline`` over
#: ``n`` virtual shards of the card; "kstream", kstream's one-shot stage
#: at (k, mode) on the genome ``paths[0]``.  Prints one JSON line.
SQUEEZE_RUN = """
import json, os, sys, torch
import numpy as np
os.environ.pop("KRISP_TPU_HBM_BUDGET", None)
from krisp_tpu_torch import budget
from krisp_tpu_torch.engine.pipeline import (KmerGeometry, detect_bits,
    fused_charge, genome_key_tables, run_pipeline, takes_fused)
from krisp_tpu_torch.io.fasta import bucket_size, load_buffer
from krisp_tpu_torch.kstream_device import (_run_stage, device_plan,
    kstream_route)
from krisp_tpu_torch.metrics import GLOBAL as METRICS
from krisp_tpu_torch.ops.encode import KeyLayout
from krisp_tpu_torch.ops.intersect import global_stage
from krisp_tpu_torch.parallel.distributed import make_mesh
paths, geom, reserve, kind, n = json.loads(sys.argv[1])
dev = torch.device("cuda", 0)
buffers = [load_buffer(p) for p in paths]
if kind == "kstream":
    k, mode = geom
    padded = np.zeros(bucket_size(buffers[0].size), np.uint8)
    padded[:buffers[0].size] = buffers[0]
    charge = padded.size * budget.kstream_card_bytes(k, mode)
else:
    sizes = [b.size for b in buffers]
    layout = KeyLayout(*geom, detect_bits(buffers), len(paths))
    L = sum(geom)
    mesh = make_mesh(devices=[dev] * n) if kind == "sharded" else None
    charge = (fused_charge(sizes, layout, L)[1] if mesh is None
              else n * fused_charge(sizes, layout, L, n)[1])
del buffers
free0 = torch.cuda.mem_get_info(dev)[0]
fill = (free0 - charge - reserve) // (2 << 20) * (2 << 20)
filler = torch.empty(fill, dtype=torch.uint8, device=dev)
free1 = torch.cuda.mem_get_info(dev)[0]
card_budget = budget.device_budget(dev)
torch.cuda.reset_peak_memory_stats(dev)
METRICS.reset()
if kind == "kstream":
    routed = kstream_route(padded.size, k, mode, card_budget, 1, dev)
    plan = device_plan(kmers=k, disallow="Nn", sort=True,
                       complements=mode == "complements",
                       canonicals=mode == "canonicals")
    out = _run_stage(padded, plan, dev)
else:
    routed = ("fused" if takes_fused(sizes, layout, L, dev, mesh)
              else "staged")
    if kind == "device":   # the stage frees the table once sorted
        out = global_stage([genome_key_tables(paths, KmerGeometry(*geom),
                                              device=dev)[0]], layout,
                           len(paths))
    else:
        out = run_pipeline(paths[:2], paths[2:], KmerGeometry(*geom),
                           device=dev, mesh=mesh)
        if "intersect" in METRICS.stages:
            routed = "staged"
torch.cuda.synchronize()
print(json.dumps(dict(
    kind=kind, reserve_bytes=reserve, charge_bytes=charge,
    budget_bytes=card_budget, routed=routed, free_bytes=free0,
    free_after_fill_bytes=free1,
    peak_bytes=torch.cuda.max_memory_allocated(dev) - fill,
    free_at_end_bytes=torch.cuda.mem_get_info(dev)[0])))
"""


def _squeeze_run(paths, geom, reserve, kind, n=1):
    """``SQUEEZE_RUN`` in a new process: its JSON line as a dict, or
    {"error": the last line of its standard error}."""
    out = subprocess.run([sys.executable, "-c", SQUEEZE_RUN, json.dumps(
        [[str(p) for p in paths], list(geom), reserve, kind, n])],
        capture_output=True, text=True, cwd=Path(__file__).parent)
    if out.returncode != 0:
        return dict(error=(out.stderr.strip().splitlines() or ["?"])[-1])
    return json.loads(out.stdout.strip().splitlines()[-1])


def phase_reserve(name, paths, geom, kind, n=1):
    """14: ``SQUEEZE_RUN`` of one run under ``budget.CARD_RESERVE``, which
    must route the run to the one-device route (fused, or kstream's one
    shot) and finish.  Returns its JSON line, with the reserve's part
    that the run left free at its end."""
    from krisp_tpu_torch import budget
    torch.cuda.empty_cache()
    sq = _squeeze_run(paths, geom, budget.CARD_RESERVE, kind, n)
    want = "one_shot" if kind == "kstream" else "fused"
    check("error" not in sq and sq["routed"] == want, f"budget reserve "
          f"{name}: with the charge plus the reserve free: {sq}")
    room = sq["charge_bytes"] + sq["reserve_bytes"]
    sq.update(name=name, reserve_left_bytes=sq["free_at_end_bytes"])
    print(f"phase 14 budget reserve {name} ({kind}) in a new process with "
          f"{room / 2**20:.1f} MiB free (charge "
          f"{sq['charge_bytes'] / 2**20:.1f} + reserve "
          f"{sq['reserve_bytes'] / 2**20:.1f}): routed {sq['routed']}, peak "
          f"{sq['peak_bytes'] / 2**20:.1f} MiB, "
          f"{sq['free_at_end_bytes'] / 2**20:.1f} MiB free at the end",
          flush=True)
    return sq


def _measure_peak(dev, fn):
    """(fn(), peak bytes above what was allocated before, the allocator's
    cached bytes beyond its peak, device bytes taken outside the
    allocator during the call)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    free0, res0 = torch.cuda.mem_get_info(dev)[0], torch.cuda.memory_reserved(
        dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    gap = torch.cuda.max_memory_reserved(dev) - peak
    outside = ((free0 - torch.cuda.mem_get_info(dev)[0])
               - (torch.cuda.memory_reserved(dev) - res0))
    return out, peak - base, gap, outside


def phase_budget(dev, genomes, full_paths, td, ks_files):
    """14: the card's budget (``budget.device_budget`` with
    KRISP_TPU_HBM_BUDGET unset) and its reserve; for each layout at each
    size of ``BUDGET_SIZES``, and for one genome at 40 Mb, a fused search
    routed by that budget whose peak is within ``fused_charge`` and whose
    table's extraction alone (``genome_key_tables``) gives the
    extraction's bytes a genome row; ``phase_reserve`` of six runs; the
    spacer once at 5 x 100 Mb (about 1.0e9 rows), its
    unfiltered groups equal to the planted answer; the routing on
    synthetic sizes; and kstream's one-shot stage on the 40 Mb genome
    against its charge."""
    from krisp_tpu_torch import budget
    from krisp_tpu_torch.engine.pipeline import (KmerGeometry, fused_charge,
                                                 genome_key_tables,
                                                 run_pipeline, takes_fused)
    from krisp_tpu_torch.io.fasta import bucket_size, load_buffer
    from krisp_tpu_torch.kstream_device import (_run_stage, device_plan,
                                                kstream_route)
    from krisp_tpu_torch.metrics import GLOBAL as METRICS
    from krisp_tpu_torch.ops.encode import KeyLayout
    from krisp_tpu_torch.ops.intersect import global_stage

    old = _set_env(KRISP_TPU_HBM_BUDGET=None)
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info(dev)
    cached = torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(
        dev)
    card_budget = budget.device_budget(dev)
    res = dict(free_bytes=free, total_bytes=total, budget_bytes=card_budget,
               reserve_bytes=budget.CARD_RESERVE, runs=[], kstream=[])
    print(f"phase 14 budget: {card_budget:,} B ({card_budget / 2**30:.2f} "
          f"GiB) = free {free:,} B + cached {cached:,} B - reserve "
          f"{budget.CARD_RESERVE:,} B; card total {total:,} B",
          flush=True)
    check(0 < card_budget < total, "budget: not within the card")

    def fused_run(name, paths, geom, planted=None):
        """One search routed by the card's budget, its peak against its
        charge.  One genome: every row survives, so the device part alone
        (the table and the global stage; the host decode of every row
        would take minutes), with the routing asked of ``takes_fused``."""
        sizes, layout = _sizes_layout(paths, geom)
        rows, charge = fused_charge(sizes, layout, sum(geom))
        genome_rows = rows // len(paths)
        g = KmerGeometry(*geom)
        device_only = len(paths) == 1
        METRICS.reset()
        t0 = time.perf_counter()
        if device_only:
            check(takes_fused(sizes, layout, sum(geom), dev),
                  f"budget {name}: the default budget does not route it "
                  "fused")
            out, peak, gap, outside = _measure_peak(dev, lambda: global_stage(
                [genome_key_tables(paths, g, device=dev)[0]], layout, 1))
            survivors = out[2].numel()
            del out
        else:
            groups, peak, gap, outside = _measure_peak(
                dev, lambda: run_pipeline(paths[:2], paths[2:], g,
                                          ingroup_filter=False, device=dev))
            check("intersect" not in METRICS.stages
                  and "pull" in METRICS.stages,
                  f"budget {name}: the default budget did not route it "
                  "fused")
            survivors = METRICS.stages["pull"].items
        dt = time.perf_counter() - t0
        check(peak <= charge, f"budget {name}: peak {peak} B over the "
              f"charge {charge} B")
        if planted is not None:
            want = _planted_groups(planted, geom)
            check(_groups_as_dict(groups) == want,
                  f"budget {name}: groups differ from the planted answer")
        table_bytes = 4 * layout.n_words * rows
        _, ext_peak, _, _ = _measure_peak(dev, lambda: genome_key_tables(
            paths, g, device=dev)[0])
        r = dict(name=name, files=len(paths), size=max(sizes), rows=rows,
                 n_words=layout.n_words, bits=layout.bits, charge_bytes=charge,
                 peak_bytes=peak, peak_row_bytes=peak / rows,
                 charge_row_bytes=charge / rows, survivor_rows=survivors,
                 cached_gap_bytes=gap, outside_bytes=outside,
                 extract_peak_bytes=ext_peak,
                 extract_genome_row_bytes=(ext_peak - table_bytes)
                 / genome_rows, seconds=dt, device_only=device_only)
        res["runs"].append(r)
        print(f"phase 14 budget {name} ({len(paths)} x {max(sizes):,}, "
              f"{layout.bits}-bit, {layout.n_words} words): {rows:,} rows, "
              f"{survivors:,} survivors, peak {peak / 2**20:.1f} MiB "
              f"({r['peak_row_bytes']:.2f} B a row) <= charge "
              f"{charge / 2**20:.1f} MiB ({r['charge_row_bytes']:.2f}); "
              f"extraction {ext_peak / 2**20:.1f} MiB "
              f"({r['extract_genome_row_bytes']:.2f} B a genome row beside "
              f"the table); allocator cache beyond the peak "
              f"{gap / 2**20:.1f} MiB, outside it {outside / 2**20:.1f} MiB; "
              f"{dt:.2f} s" + (" (device part)" if device_only else ""),
              flush=True)
        return r

    sets = {}
    for name, geom, iupac in (("spacer", SPACER, False),
                              ("amplicon", AMPLICON, False),
                              ("iupac", SPACER, True)):
        for size in BUDGET_SIZES:
            if size == LARGE:
                paths = genomes[name][1]
            elif size == FULL and name == "spacer":
                paths = full_paths
            else:
                paths = synth_genomes(td / f"budget_{name}_{size}", size,
                                      geom, iupac)[0]
            sets[name, size] = paths
            fused_run(f"{name} 5 x {size // 10**6} Mb", paths, geom)
    # every row a survivor: the peaks nearest their charges
    for name in ("spacer", "iupac"):
        fused_run(f"{name} 1 x {FULL // 10**6} Mb", sets[name, FULL][:1],
                  SPACER)
    # the reserve: the runs whose peaks come nearest their charges, a whole
    # run_pipeline at 5 x 40 Mb (phase 10's route), the sharded route and
    # kstream's stage, each with only its charge and the reserve free
    res["reserve"] = [
        phase_reserve(f"{name} 1 x {FULL // 10**6} Mb",
                      sets[name, FULL][:1], SPACER, "device")
        for name in ("spacer", "iupac")]
    res["reserve"] += [
        phase_reserve("amplicon 5 x 4 Mb", sets["amplicon", LARGE], AMPLICON,
                      "pipeline"),
        phase_reserve("spacer 5 x 40 Mb", full_paths, SPACER, "pipeline"),
        phase_reserve(f"amplicon 5 x 4 Mb on {SHARD_FULL} virtual shards",
                      sets["amplicon", LARGE], AMPLICON, "sharded",
                      SHARD_FULL),
        phase_reserve("kstream 40 Mb k 28 complements",
                      [ks_files["40mb_upper"]], (28, "complements"),
                      "kstream")]
    for name in ("spacer", "amplicon", "iupac"):
        for size in BUDGET_SIZES[1:]:
            if (name, size) != ("spacer", FULL):
                shutil.rmtree(td / f"budget_{name}_{size}")

    near_paths, planted = synth_genomes(td / "budget_near_guard", NEAR_GUARD,
                                        SPACER)
    near = fused_run(f"spacer 5 x {NEAR_GUARD // 10**6} Mb", near_paths,
                     SPACER, planted)
    res["near_guard"] = near
    shutil.rmtree(td / "budget_near_guard")

    # the routing on synthetic sizes, nothing allocated, each under a
    # budget named as a user names one: the card's budget read above, or
    # 1 PiB for the row guard alone
    def routed(sizes, layout, L, named):
        _set_env(KRISP_TPU_HBM_BUDGET=str(named))
        return takes_fused(sizes, layout, L, dev)

    decisions = {}
    for name, geom, bits in (("spacer", SPACER, 2), ("amplicon", AMPLICON, 2),
                             ("iupac", SPACER, 4)):
        decisions[f"{name} 5 x 40 Mb"] = (
            routed([FULL] * N_FILES, KeyLayout(*geom, bits, N_FILES),
                   sum(geom), card_budget), True)
    uneven = [600_000_000] + [1_000_000] * 9
    lay10 = KeyLayout(*SPACER, 2, 10)
    rows_uneven, charge_uneven = fused_charge(uneven, lay10, sum(SPACER))
    decisions["spacer 600 Mb + 9 x 1 Mb"] = (
        routed(uneven, lay10, sum(SPACER), card_budget), False)
    # the row guard alone: under a 1 PiB budget a table just past 2**31
    # rows is staged and one a bucket a genome smaller is fused
    decisions["spacer 600 Mb + 9 x 1 Mb, 1 PiB budget"] = (
        routed(uneven, lay10, sum(SPACER), 1 << 50), False)
    check(rows_uneven >= budget.ROW_LIMIT,
          "budget: 600 Mb + 9 x 1 Mb under the row limit")
    lay5 = KeyLayout(*SPACER, 2, N_FILES)
    guard = [-(-budget.ROW_LIMIT // (2 * N_FILES)) + sum(SPACER)] * N_FILES
    rows_guard, charge_guard = fused_charge(guard, lay5, sum(SPACER))
    decisions[f"spacer 5 x {guard[0]:,}, 1 PiB budget"] = (
        routed(guard, lay5, sum(SPACER), 1 << 50), False)
    check(rows_guard >= budget.ROW_LIMIT,
          "budget: the row-guard case is under the row limit")
    under = [guard[0] - (1 << 16)] * N_FILES
    decisions[f"spacer 5 x {under[0]:,}, 1 PiB budget"] = (
        routed(under, lay5, sum(SPACER), 1 << 50), True)
    # just past the budget: the amplicon layout, a bucket at a time
    lay_a = KeyLayout(*AMPLICON, 2, N_FILES)
    size = 1 << 16
    while fused_charge([size * 2] * N_FILES, lay_a, sum(AMPLICON))[1] \
            <= card_budget:
        size *= 2
    lo, hi = size, size * 2   # fits at lo, not at hi
    while hi - lo > 1 << 16:
        mid = (lo + hi) // 2 // (1 << 16) * (1 << 16)
        if fused_charge([mid] * N_FILES, lay_a, sum(AMPLICON))[1] \
                <= card_budget:
            lo = mid
        else:
            hi = mid
    for sz, want in ((lo, True), (hi, False)):
        decisions[f"amplicon 5 x {sz:,} (budget edge)"] = (
            routed([sz] * N_FILES, lay_a, sum(AMPLICON), card_budget), want)
    _set_env(KRISP_TPU_HBM_BUDGET=None)
    for what, (got, want) in decisions.items():
        print(f"phase 14 budget routing {what}: "
              f"{'fused' if got else 'staged'}", flush=True)
        check(got == want, f"budget routing {what}: "
              f"{'fused' if got else 'staged'}, want "
              f"{'fused' if want else 'staged'}")
    res["routing"] = {k: v[0] for k, v in decisions.items()}
    res["uneven"] = dict(rows=rows_uneven, charge_bytes=charge_uneven,
                         windows_summed=2 * sum(bucket_size(s)
                                                for s in uneven))
    res["row_guard"] = dict(rows=rows_guard, charge_bytes=charge_guard)
    res["budget_edge_sizes"] = [lo, hi]
    print(f"phase 14 budget: 600 Mb + 9 x 1 Mb allocates {rows_uneven:,} "
          f"rows (charged {charge_uneven / 1e9:.1f} GB; the sum of its "
          f"buckets is {res['uneven']['windows_summed']:,} windows); the "
          f"row-guard case {rows_guard:,} rows charged "
          f"{charge_guard / 1e9:.1f} GB", flush=True)

    # kstream's one-shot stage against its charge
    buf = load_buffer(str(ks_files["40mb_upper"]))
    padded = np.zeros(bucket_size(buf.size), np.uint8)
    padded[:buf.size] = buf
    del buf
    for k, mode in KS_BUDGET_GRID:
        plan = device_plan(kmers=k, disallow="Nn", sort=True,
                           complements=mode == "complements",
                           canonicals=mode == "canonicals")
        est = padded.size * budget.kstream_card_bytes(k, mode)
        old_est = padded.size * budget.kstream_tpu_bytes(k)
        check(kstream_route(padded.size, k, mode, card_budget) == "one_shot",
              f"budget kstream k {k} {mode}: not routed one shot")
        _, peak, gap, _ = _measure_peak(dev, lambda: _run_stage(padded, plan,
                                                                dev))
        check(peak <= est, f"budget kstream k {k} {mode}: peak {peak} B "
              f"over the charge {est} B")
        res["kstream"].append(dict(k=k, mode=mode, windows=padded.size,
                                   peak_bytes=peak, charge_bytes=est,
                                   krisp_tpu_estimate_bytes=old_est,
                                   cached_gap_bytes=gap))
        print(f"phase 14 budget kstream 40 Mb k {k} {mode}: peak "
              f"{peak / 2**20:.1f} MiB ({peak / padded.size:.2f} B a window) "
              f"<= charge {est / 2**20:.1f} MiB (krisp_tpu's estimate "
              f"{old_est / 2**20:.1f} MiB)", flush=True)
    seg = kstream_route(1_100_000_000, 28, "complements", 1 << 50)
    check(seg == "segmented", f"budget kstream: 2.2e9 rows routed {seg}")
    print("phase 14 budget kstream: 1.1e9 window starts with complements "
          "(2.2e9 rows) under a 1 PiB budget: segmented", flush=True)
    _set_env(**old)
    return res


def _free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def phase_nccl(dev, genomes, ks_files):
    """13 d: a one-rank NCCL process group (``multihost.init_runtime``,
    ``pod_mesh``) carries the process-group transport of all three
    verticals: the spacer search at 5 x 1 Mb (groups and CSV == one
    device's, every sharded kernel but the merge launched), kstream k 28
    canonicals on the 1 Mb genome (== one device's table) and the
    classifier at 4,096 x 500 by variants and by samples (== one
    device's); the group is destroyed after."""
    import torch.distributed as dist
    from krisp_tpu_torch.engine.pipeline import KmerGeometry, run_pipeline
    from krisp_tpu_torch.io.fasta import load_buffer
    from krisp_tpu_torch.ops import vcfclass as vc
    from krisp_tpu_torch.parallel.kstream_shard import sharded_kstream_table
    from krisp_tpu_torch.parallel.multihost import init_runtime, pod_mesh
    from krisp_tpu_torch.parallel.vcf_shard import (
        classify_batch_packed_sharded)
    t0 = time.perf_counter()
    check(init_runtime(f"tcp://localhost:{_free_port()}", 1, 0),
          "nccl: init_runtime returned False")
    try:
        check(dist.get_backend() == "nccl", "nccl: not an NCCL group")
        mesh = pod_mesh()
        check(mesh.size == 1 and mesh.device == dev and mesh.group is not None,
              f"nccl: unexpected mesh {mesh}")
        paths = genomes["spacer"][0][0]
        g = KmerGeometry(*SPACER)
        groups, _, launches, _ = _sharded_run(
            dev, paths, SPACER, mesh,
            ("window_keys_both", "sort_words", "survivor_scan"), "nccl")
        check(_groups_as_dict(groups) == _groups_as_dict(run_pipeline(
            paths[:2], paths[2:], g, ingroup_filter=False, device=dev)),
            "nccl: survivor groups differ from one device's")
        check(_csv_bytes(run_pipeline(paths[:2], paths[2:], g, device=dev,
                                      mesh=mesh))
              == _csv_bytes(run_pipeline(paths[:2], paths[2:], g,
                                         device=dev)),
              "nccl: CSV bytes differ from one device's")
        buf = load_buffer(str(ks_files["1mb_upper"]))
        got = sharded_kstream_table(mesh, buf, 28, "canonicals", False)
        want = sharded_kstream_table(card_mesh(dev, 1), buf, 28,
                                     "canonicals", False)
        check(all(np.array_equal(a, b) for a, b in zip(got, want))
              and got[0].shape[1] > 0, "nccl: kstream table differs")
        V, S, A, G = VCF_COHORT[1], *VCF_COHORT[2:]
        arrays = vcf_cohort_batch(V, V, S, A, G)
        kw = dict(min_samples=3, min_reads=10, min_geno_qual=40,
                  min_freq=0.1, min_map_qual=30, min_var_qual=10,
                  min_samp_prop=0.9)
        t = {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}
        one = vc.classify_batch_packed(n_groups=G, **t, **kw)
        for shard in ("variants", "samples"):
            check(torch.equal(classify_batch_packed_sharded(
                mesh, **arrays, n_groups=G, shard=shard, **kw), one),
                f"nccl: vcf by {shard} differs from one device's")
        dist.barrier()
    finally:
        dist.destroy_process_group()
    dt = time.perf_counter() - t0
    print(f"phase 13d one-rank NCCL group: the spacer search (5 x 1 Mb), "
          f"kstream (1 Mb, k 28) and the classifier ({V} x {S}, both axes) "
          f"== one device's, {dt:.1f} s with bring-up, launches {launches}",
          flush=True)
    return dict(wall_s=dt, launches=launches)


def phase_profile_dir(dev, genomes, td: Path):
    """13 e: ``krisp_fasta --profile-dir`` on the card at 5 x 1 Mb spacer:
    the same bytes as without the flag, and one trace file whose device
    events name the window-key, sort and scan kernels."""
    out_dir = td / "out_profile"
    out_dir.mkdir()
    paths = genomes["spacer"][0][0]
    plain = _cli(paths, SPACER, "cuda", out_dir, name="plain")
    prof = td / "profile"
    traced = _cli(paths, SPACER, "cuda", out_dir,
                  ("--profile-dir", str(prof)), name="traced")
    check(traced == plain, "--profile-dir changed the output bytes")
    traces = list(prof.glob("*.pt.trace.json"))
    check(len(traces) == 1, f"--profile-dir wrote {traces}")
    events = json.loads(traces[0].read_text())["traceEvents"]
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    want = {"window_keys": ("window_keys_kernel",),
            "sort_words": ("vary_kernel", "onesweep_kernel"),
            "survivor_scan": ("scan_kernel",)}
    found = {k: sorted({w for n in kernels for w in ws if w in n})
             for k, ws in want.items()}
    check(all(found.values()),
          f"--profile-dir: the trace misses a kernel of the path: {found}")
    print(f"phase 13e krisp_fasta --profile-dir: same bytes, trace "
          f"{traces[0].name} ({traces[0].stat().st_size} B), {len(kernels)} "
          f"kernel names, the path's: {found}", flush=True)
    return dict(trace_bytes=traces[0].stat().st_size, kernels=found)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import krisp_tpu_torch  # noqa: F401  (fails outside the repository)

    t_start = time.perf_counter()
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
        all3 = ("window_keys_both", "sort_words", "survivor_scan")
        for n, name, geom, variants, kernels in (
                (4, "spacer", SPACER, [()], all3),
                (5, "amplicon", AMPLICON, [(), ("--primer3",)], all3),
                (6, "iupac", SPACER, [("--dot-alignment",)],
                 ("sort_words", "survivor_scan"))):
            out_dir = td / f"out_{name}"
            out_dir.mkdir()
            paths[name] = phase_path(n, name, geom, dev, *genomes[name],
                                     out_dir, variants, kernels)
        merge_res = phase_merge(dev, genomes["spacer"][1],
                                genomes["amplicon"][1])
        torch.cuda.empty_cache()
        ab_res = phase_ab(dev)
        torch.cuda.empty_cache()
        ooc_small = phase_out_of_core_small(dev, genomes, td)
        ooc_full = phase_out_of_core_full(dev, td)
        sharded = dict(intersection=phase_sharded_intersection(dev, genomes),
                       full=phase_sharded_full(dev, ooc_full))
        ks_files = kstream_inputs(td)
        kstream = dict(small=phase_kstream_small(td, ks_files),
                       full=phase_kstream_full(dev, ks_files),
                       segmented=phase_kstream_segmented(td, ks_files))
        vcf = dict(small=phase_vcf_small(td),
                   classifier=phase_vcf_classifier(dev),
                   full=phase_vcf_full(dev, td))
        sharded.update(
            kstream=phase_sharded_kstream(
                dev, ks_files,
                kstream["full"]["k28_canonicals_device"]["sha256"]),
            vcf=phase_sharded_vcf(dev),
            nccl=phase_nccl(dev, genomes, ks_files),
            profile_dir=phase_profile_dir(dev, genomes, td))
        budget_res = phase_budget(dev, genomes, ooc_full.pop("paths"), td,
                                  ks_files)

    main_pack = pack_res[0]
    main_scan = scan_res[0]
    main_sort = sort_res[0]
    main_merge = merge_res[0]
    main_launches = paths["spacer"]["launches"]
    main_runs = len(paths["spacer"]["times_s"])

    # phase 13: launches in one sharded run (spacer 5 x 4 Mb, 4 virtual
    # shards; the 40 Mb run; kstream's 40 Mb run)
    sharded_runs = (sharded["intersection"][f"spacer_{SHARD_FULL}"],
                    sharded["full"], sharded["kstream"])

    def row(name, source, replaces, launches, runs, results, main, **extra):
        return dict(name=name, route="cuda",
                    source=f"krisp_tpu_torch/csrc/{source}",
                    replaces=replaces, launches=launches,
                    launches_per_run=launches / runs,
                    sharded_launches_per_run=[r["launches"][name]
                                              for r in sharded_runs],
                    vcf_launches=vcf["full"]["launches"][name],
                    max_abs_err=max(r["max_abs_err"] for r in results),
                    ms=main["ms"], busy_ms=main["busy_ms"],
                    plain_ms=main["plain_ms"],
                    bound_ms=main["bound_ms"], bound_by="bytes",
                    library_ms=main.get("library_ms"), **extra)

    # the spacer path (phase 4) is the main path: its window keys come from
    # the table mode, whose figures at 25/1/2 make the row; the TPU mode's
    # (which only the tests and this smoke call) stand beside them
    # kstream (phase 11): launches a run of the 40 Mb k 28 device engine
    # and of the 2 Mb segmented run, and the kernels at its shapes
    ks_full = kstream["full"]
    ks_runs = ks_full["k28_canonicals_device"]["launches_per_run"]
    ks_seg = kstream["segmented"]["launches"]

    def ks_extra(name):
        shapes = ks_full["kernels"][name]
        return dict(kstream_launches_per_run=ks_runs[name],
                    kstream_segmented_launches_per_run=ks_seg[name],
                    kstream_shapes=shapes)

    main_table = dict(ms=main_pack["table_ms"],
                      busy_ms=main_pack["table_busy_ms"],
                      plain_ms=main_pack["table_plain_ms"],
                      bound_ms=main_pack["table_bound_ms"])
    kernels = [
        row("window_keys_both", "window_keys.cu",
            "krisp_tpu/ops/pallas_pack.py:169",
            main_launches["window_keys_both"], main_runs,
            pack_res + ks_full["kernels"]["window_keys_both"],
            main_table, tpu_mode_ms=main_pack["ms"],
            tpu_mode_busy_ms=main_pack["busy_ms"],
            tpu_mode_plain_ms=main_pack["plain_ms"],
            tpu_mode_bound_ms=main_pack["bound_ms"],
            **ks_extra("window_keys_both")),
        row("sort_words", "sort_words.cu", "krisp_tpu/ops/pallas_sort.py:173",
            main_launches["sort_words"], main_runs,
            sort_res + ks_full["kernels"]["sort_words"], main_sort,
            **ks_extra("sort_words")),
        # the global stage scans in layout mode: its figures make the row,
        # the valid-array mode's stand beside them
        row("survivor_scan", "survivor_scan.cu",
            "krisp_tpu/ops/pallas_scan.py:218",
            main_launches["survivor_scan"], main_runs, scan_res, main_scan,
            busy_by_kernel=main_scan["by_kernel"],
            valid_mode_ms=main_scan["valid_mode_ms"],
            valid_mode_busy_ms=main_scan["valid_mode_busy_ms"],
            valid_mode_plain_ms=main_scan["valid_mode_plain_ms"],
            valid_mode_bound_ms=main_scan["valid_mode_bound_ms"]),
        # its main path stays the A/B entry point; the sharded search is
        # its production caller (sharded_launches_per_run)
        row("merge_sorted_words", "merge_words.cu",
            "krisp_tpu/ops/pallas_merge.py:161", ab_res["launches"], 1,
            merge_res, main_merge),
    ]
    total_s = time.perf_counter() - t_start
    print("details " + json.dumps(dict(
        gpu=smi, torch=torch.__version__, cuda=torch.version.cuda,
        build_s=build_s, window_keys=pack_res, sort_words=sort_res,
        survivor_scan=scan_res, paths=paths, merge_sorted_words=merge_res,
        ab_merge_path=ab_res, out_of_core_small=ooc_small,
        out_of_core_full=ooc_full, kstream=kstream, vcf=vcf,
        sharded=sharded, budget=budget_res, total_s=total_s)))
    print(f"chip_smoke: {total_s:.1f} s in all", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
