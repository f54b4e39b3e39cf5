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
     per call (from a profiler trace of 5 calls);
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
     bytes: fused (budget raised; one warm-up, 2 timed runs), staged as the
     default budget routes it (1 run, no temporary table directory left),
     ``--workdir`` cold (1 run) and warm (2 runs); the window-key, sort and
     scan kernels must have launched in the staged runs.
Then a ``details`` line with every measurement as JSON, one JSON line of
per-kernel results (each with its least time ``bound_ms``: the bytes its
inputs and outputs hold once, over the card's 3.35 TB/s), the
``nvidia-smi`` name/power line, and, last, ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

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
    calls, and that time by kernel: {first 40 characters of the name: ms
    a call}.  A trace that holds no device event at all (the profiler now
    and then returns one empty) is taken again, up to three times."""
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
    check(False, "the profiler saw no device time in three traces")


def busy_ms(fn, reps=5):
    """``busy_by_kernel``'s total alone."""
    return busy_by_kernel(fn, reps)[0]


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
                  f"kernel {ms:.4f} ms ({busy:.4f} busy), plain "
                  f"{plain_ms:.3f} ms; table mode kernel {table_ms:.4f} ms "
                  f"({table_busy:.4f} busy), plain {table_plain_ms:.3f} "
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
          f"{passes} passes, kernel {ms:.3f} ms ({busy:.3f} busy), "
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
              f"{ms:.3f} ms ({busy:.4f} busy: {split}), plain "
              f"{plain_ms:.3f} ms; valid mode kernel {valid_ms:.3f} ms "
              f"({valid_busy:.4f} busy), plain {valid_plain_ms:.3f} ms",
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
    """5 x 40 Mb spacer through the CLI: fused, staged as the budget routes
    it, ``--workdir`` cold and warm; equal CSV bytes everywhere."""
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

    run_kind("fused", 2, budget=1 << 40, warmup=True)
    routed = run_kind("staged_routed", 1)
    check(routed["passes"] and routed["passes"] >= 2,
          f"out-of-core: the default budget did not route 5 x 40 Mb staged "
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
                staged_launches=staged_launches, disk_free_bytes=free)


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

    main_pack = pack_res[0]
    main_scan = scan_res[0]
    main_sort = sort_res[0]
    main_merge = merge_res[0]
    main_launches = paths["spacer"]["launches"]
    main_runs = len(paths["spacer"]["times_s"])

    def row(name, source, replaces, launches, runs, results, main, **extra):
        return dict(name=name, route="cuda",
                    source=f"krisp_tpu_torch/csrc/{source}",
                    replaces=replaces, launches=launches,
                    launches_per_run=launches / runs,
                    max_abs_err=max(r["max_abs_err"] for r in results),
                    ms=main["ms"], busy_ms=main["busy_ms"],
                    plain_ms=main["plain_ms"],
                    bound_ms=main["bound_ms"], bound_by="bytes",
                    library_ms=main.get("library_ms"), **extra)

    # the spacer path (phase 4) is the main path: its window keys come from
    # the table mode, whose figures at 25/1/2 make the row; the TPU mode's
    # (which only the tests and this smoke call) stand beside them
    main_table = dict(ms=main_pack["table_ms"],
                      busy_ms=main_pack["table_busy_ms"],
                      plain_ms=main_pack["table_plain_ms"],
                      bound_ms=main_pack["table_bound_ms"])
    kernels = [
        row("window_keys_both", "window_keys.cu",
            "krisp_tpu/ops/pallas_pack.py:169",
            main_launches["window_keys_both"], main_runs, pack_res,
            main_table, tpu_mode_ms=main_pack["ms"],
            tpu_mode_busy_ms=main_pack["busy_ms"],
            tpu_mode_plain_ms=main_pack["plain_ms"],
            tpu_mode_bound_ms=main_pack["bound_ms"]),
        row("sort_words", "sort_words.cu", "krisp_tpu/ops/pallas_sort.py:173",
            main_launches["sort_words"], main_runs, sort_res, main_sort),
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
        # no production path merges: its main path is the A/B entry point
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
        out_of_core_full=ooc_full, total_s=total_s)))
    print(f"chip_smoke: {total_s:.1f} s in all", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
