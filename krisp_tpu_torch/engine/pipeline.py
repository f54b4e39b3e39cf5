"""End-to-end krisp_fasta search on one device
(``krisp_tpu/engine/pipeline.py``, the single-device branches).

Fused path (the whole key table on the card at once):

  FASTA -> uint8 buffers -> per genome: 2-bit keys: host 2-bit pack +
  validity bitmap, upload, window keys of both strands (CUDA kernel);
  4-bit (IUPAC) keys: upload the bytes, window keys in torch ops -> one
  table -> global stage -> pull -> host decode -> FlankGroup objects.

The global stage is sort (CUDA kernel) -> survivor scan (CUDA kernel) ->
compaction; wide keys (more than 2 words and a flank of 32 bits or more)
first pass the one-word prefix prefilter and run that stage on the rows it
keeps.

Staged (out-of-core) path, taken with a ``workdir`` or past the
device-memory budget (``KRISP_TPU_HBM_BUDGET``, read at call time, default
8 GiB, against 56 bytes a window as krisp_tpu estimates it):

  per genome, chunks of ``KRISP_TPU_CHUNK_BASES`` window starts (default
  64 Mb): upload the bytes, window keys, sort, duplicate collapse, pull ->
  sorted sub-runs cached on disk (``engine.checkpoint.TableCache``, a copy
  of krisp_tpu's, same key and format) -> range-partitioned global stage
  (``engine.bigscale``) -> the same decode.

``KmerGeometry``, ``solve_geometry``, ``detect_bits``,
``_pack_genomes_host``, ``_encoding_tables`` and ``_group_epilogue`` are
copies of krisp_tpu's JAX-free helpers (pinned equal by
tests/test_torch_encode.py); ``dna``, ``io``, ``engine.groups``,
``engine.render``, ``engine.checkpoint`` and ``thermo`` are the port's own
copies of krisp_tpu's host modules.  Several devices raise
``NotImplementedError`` naming the ROADMAP.md item that ports them.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from dataclasses import dataclass

import numpy as np
import torch

from .. import dna
from ..convert import keys_from_numpy, keys_to_numpy
from ..device import resolve_device
from ..io.fasta import bucket_size, load_buffer, simple_name
from ..metrics import GLOBAL as METRICS
from ..ops.encode import KeyLayout
from ..ops.intersect import (_all_window_keys, compact_rows, dedup_sorted,
                             extract_keys_ascii, extract_keys_packed_in,
                             global_stage)
from ..ops.scan import valid_rows
from ..ops.sort import sort_words
from .bigscale import partitioned_global_intersect
from .checkpoint import TableCache
from .groups import FlankGroup, KmerAmplicon


@dataclass
class KmerGeometry:
    left: int      # conserved flank length on the left
    mid: int       # diagnostic region length
    right: int     # conserved flank length on the right

    @property
    def total(self) -> int:
        return self.left + self.mid + self.right


def solve_geometry(amplicon=None, diagnostic=None, conserved=None,
                   conserved_left=None, conserved_right=None) -> KmerGeometry:
    """Derive (left, mid, right) from any sufficient flag subset
    (parity: krisp_fasta.py:178-213)."""
    if amplicon is not None:
        if diagnostic is not None:
            conserved = (amplicon - diagnostic) // 2
            return KmerGeometry(conserved, diagnostic, conserved)
        if conserved is not None:
            return KmerGeometry(conserved, amplicon - 2 * conserved, conserved)
        if conserved_left is not None and conserved_right is not None:
            return KmerGeometry(conserved_left,
                                amplicon - conserved_left - conserved_right,
                                conserved_right)
        raise ValueError("Could not deduce input parameters")
    if diagnostic is not None:
        if conserved is not None:
            return KmerGeometry(conserved, diagnostic, conserved)
        if conserved_left is not None and conserved_right is not None:
            return KmerGeometry(conserved_left, diagnostic, conserved_right)
    raise ValueError("Could not deduce input parameters")


def detect_bits(buffers) -> int:
    """Choose a common per-base encoding width for a set of genome buffers."""
    return max(dna.choose_bits(buf) for buf in buffers)


def _pack_genomes_host(stacked: np.ndarray, omit_soft: bool):
    """2-bit code pack + validity bitmap (host side, bits == 2 only).

    The softmask/disallow policy folds into the bitmap here, so the device
    reconstructs a canonical A/C/G/T/N buffer with identical per-base
    (code, validity) from 2 bits of code and 1 bit of validity per base."""
    code_np = np.asarray(dna.CODE2_TABLE, np.uint8)
    valid_np = np.asarray(dna.base_validity_table(2, disallow="Nn",
                                                  omit_soft=omit_soft))
    F, P = stacked.shape
    c = (code_np[stacked] & 3).reshape(F, P // 4, 4)
    # pack 4 bases/byte in uint8 space (no wide temporaries), then view the
    # little-endian byte stream as uint32: base k lands at bit 2k — the
    # layout ops.intersect.unpack_genomes expects
    byte = (c[:, :, 0] | (c[:, :, 1] << 2) | (c[:, :, 2] << 4)
            | (c[:, :, 3] << 6))
    packed = np.ascontiguousarray(byte).view(np.uint32).reshape(F, P // 16)
    valid = valid_np[stacked].astype(bool)
    vbits = np.packbits(valid, axis=1, bitorder="little")
    return packed, vbits


def _encoding_tables(bits: int, omit_soft: bool):
    code_table = dna.CODE2_TABLE if bits == 2 else dna.CODE4_TABLE
    comp_table = dna.COMP2_TABLE if bits == 2 else dna.COMP4_TABLE
    valid_table = dna.base_validity_table(bits, disallow="Nn",
                                          omit_soft=omit_soft)
    return code_table, valid_table, comp_table


def over_budget(buffers) -> bool:
    """krisp_tpu's device-memory guard: the fused path holds every
    genome's window table at once, about 56 bytes a window during the sort;
    past ``KRISP_TPU_HBM_BUDGET`` bytes (read now, default 8 GiB) the input
    takes the staged path."""
    budget = int(os.environ.get("KRISP_TPU_HBM_BUDGET", 8 << 30))
    return 56 * 2 * sum(bucket_size(b.size) for b in buffers) > budget


def _fused_table(buffers, layout: KeyLayout, geom: KmerGeometry,
                 omit_soft: bool, dev):
    """Pad every genome buffer to one bucket, then per genome extract its
    sentinel-marked keys (both strands, genome id = its index) into one
    table.  2-bit keys are packed on the host and uploaded at 3 bits a
    base; 4-bit keys (any IUPAC letter in any genome) upload the bytes as
    they are.  Returns int32[W, n_files * 2 n_win]."""
    n_files, bits = len(buffers), layout.bits
    pad = bucket_size(max(b.size for b in buffers))
    stacked = np.zeros((n_files, pad), np.uint8)
    for i, buf in enumerate(buffers):
        stacked[i, :buf.size] = buf
    n_win = 2 * (pad - geom.total + 1)
    # one table filled genome by genome: no per-genome tables to concatenate
    flat = torch.empty((layout.n_words, n_files * n_win), dtype=torch.int32,
                       device=dev)
    tables = _encoding_tables(bits, omit_soft) if bits != 2 else None
    for f in range(n_files):
        rows = flat[:, f * n_win:(f + 1) * n_win]
        if bits == 2:
            with METRICS.stage("pack+upload", items=pad, device=dev):
                pk, vb = _pack_genomes_host(stacked[f:f + 1], omit_soft)
                pk, vb = keys_from_numpy(pk, dev), torch.from_numpy(vb).to(dev)
            with METRICS.stage("extract", items=n_win, device=dev):
                extract_keys_packed_in(pk, vb, f, geom.left, geom.mid,
                                       geom.right, bits, n_files, out=rows)
        else:
            with METRICS.stage("upload", items=pad, device=dev):
                buf = torch.from_numpy(stacked[f]).to(dev)
            with METRICS.stage("extract", items=n_win, device=dev):
                extract_keys_ascii(buf, f, tables, geom.left, geom.mid,
                                   geom.right, bits, n_files, out=rows)
    return flat


def genome_key_tables(paths, geom: KmerGeometry, omit_soft: bool = False,
                      device="cuda"):
    """The fused path up to the global stage: read the FASTA ``paths`` and
    build their one key table.  Returns (int32[W, n_files * 2 n_win]
    table, KeyLayout)."""
    dev = resolve_device(device)
    with METRICS.stage("read_fasta"):
        buffers = [load_buffer(path) for path in paths]
    layout = KeyLayout(geom.left, geom.mid, geom.right, detect_bits(buffers),
                       len(paths))
    return _fused_table(buffers, layout, geom, omit_soft, dev), layout


def genome_unique_table(buffer: torch.Tensor, geom: KmerGeometry, bits: int,
                        omit_soft: bool, n_files: int = 1):
    """Sorted, duplicate-collapsed KeyLayout table of one genome buffer
    (uint8[P] on the device), genome-id field zero (krisp_tpu's
    ``genome_unique_table``).

    2-bit keys come from the window-key kernel on the raw bytes (its
    arithmetic validity equals ``dna.base_validity_table(2, "Nn",
    omit_soft)`` on every byte a 2-bit input holds); 4-bit keys from
    ``window_keys_bits`` with the tables of ``_encoding_tables``.  Then the
    sort kernel and ``dedup_sorted``.  krisp_tpu pads the buffer to a
    bucket, which only adds sentinel rows; the port does not.

    Returns (words int32[W, 2 n_win], counts int32[2 n_win]); rows with
    count 0 are sentinel (duplicate or invalid) rows."""
    tables = _encoding_tables(bits, omit_soft) if bits != 2 else None
    flat = _all_window_keys(buffer, 0, geom.left, geom.mid, geom.right, bits,
                            n_files, tables, omit_soft)
    layout = KeyLayout(geom.left, geom.mid, geom.right, bits, n_files)
    # valid rows have a zero genome-id field, invalid ones the sentinel
    n_valid = int(valid_rows(flat, layout).sum())
    keys = sort_words(flat)
    del flat
    return dedup_sorted(keys, n_valid)


def _genome_table_chunked(path, geom: KmerGeometry, bits: int,
                          omit_soft: bool, chunk_size: int, n_files: int = 1,
                          device="cuda"):
    """One genome's table, built on ``device`` in bounded chunks (krisp_tpu's
    ``_genome_table_chunked``).

    Chunk i owns the window starts [i*C, (i+1)*C) and reads the bases
    [i*C, (i+1)*C + L - 1), so every window is counted once.  Each chunk's
    rows with count 0 are dropped on the card before the pull; a k-mer that
    recurs across chunks stays one row per chunk, with partial counts that
    the global stage sums.  Chunks run one after another (krisp_tpu
    overlaps a chunk's pull with the next chunk's launch).

    Returns (words uint32[W, n], counts uint32[n], offsets int64[k+1]):
    one sorted sub-run per chunk, rows [offsets[i], offsets[i+1])."""
    dev = resolve_device(device)
    buf = load_buffer(path)
    L = geom.total
    word_parts, cnt_parts = [], []
    start = 0
    while start < buf.size:
        end = min(start + chunk_size, buf.size)
        piece = buf[start:min(end + L - 1, buf.size)]
        if piece.size < L:
            break  # no window can start in this tail
        words, counts = genome_unique_table(torch.from_numpy(piece).to(dev),
                                            geom, bits, omit_soft, n_files)
        (words, counts), _ = compact_rows([words, counts], counts > 0)
        word_parts.append(keys_to_numpy(words))
        cnt_parts.append(keys_to_numpy(counts))
        start = end
    lens = [w.shape[1] for w in word_parts]
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    if not word_parts:   # a genome shorter than one window
        n_words = KeyLayout(geom.left, geom.mid, geom.right, bits,
                            n_files).n_words
        return (np.zeros((n_words, 0), np.uint32), np.zeros(0, np.uint32),
                offsets)
    return (np.concatenate(word_parts, axis=1), np.concatenate(cnt_parts),
            offsets)


def _cached_parts(paths, geom: KmerGeometry, bits: int, omit_soft: bool,
                  workdir, layout: KeyLayout, chunk_size: int | None = None,
                  device="cuda"):
    """Per-genome tables through ``TableCache`` (krisp_tpu's) in ``workdir``
    (same key and format, so either package reads the other's cache): load
    hits, build and store misses.  ``chunk_size`` defaults to
    ``KRISP_TPU_CHUNK_BASES`` (64 Mb).

    Returns per genome (words uint32[W, n], counts uint32[n], offsets
    int64[k+1]) with the genome id OR'd into the key: the input of
    ``engine.bigscale.partitioned_global_intersect``."""
    dev = resolve_device(device)
    if chunk_size is None:
        chunk_size = int(os.environ.get("KRISP_TPU_CHUNK_BASES", 64 << 20))
    n_files = len(paths)
    fword, fshift = layout.file_word_shift()
    cache = TableCache(workdir)
    parts = []
    for file_idx, path in enumerate(paths):
        hit = cache.load(path, geom, bits, omit_soft, n_files)
        if hit is None:
            with METRICS.stage("extract+sort", device=dev):
                words, counts, offsets = _genome_table_chunked(
                    path, geom, bits, omit_soft, chunk_size, n_files, dev)
            cache.store(path, geom, bits, omit_soft, words, counts,
                        offsets, n_files)
        else:
            words, counts, offsets = hit
        # the id field is zero in every stored row and equal across the
        # table, so sub-run order holds; the arrays are this call's own
        # (built here or read from the file), so the OR needs no copy
        words[fword] |= np.uint32(file_idx << fshift)
        parts.append((words, counts, offsets))
    return parts


def _decode_and_group(words_h, cnt_h, gid_h, layout: KeyLayout,
                      geom: KmerGeometry, tags, ingroup_tags, has_outgroup,
                      ingroup_filter):
    """Host decode of the survivor rows (uint32[n_keep, W]), shared by the
    fused and staged paths, then ``_group_epilogue``."""
    n_keep, bits = gid_h.size, layout.bits
    off_flank, off_mid = layout.base_offsets()
    flank_dec = dna.decode_bits(words_h, off_flank, bits)
    mid_dec = (dna.decode_bits(words_h, off_mid, bits) if geom.mid > 0
               else [""] * n_keep)
    fid_h = dna.extract_bit_field(words_h, layout.file_off, layout.file_bits)
    return _group_epilogue(n_keep, gid_h, mid_dec, flank_dec, fid_h, cnt_h,
                           geom, tags, ingroup_tags, has_outgroup,
                           ingroup_filter)


def run_pipeline(files, outgroup, geom: KmerGeometry, omit_soft: bool = False,
                 ingroup_filter: bool | None = None, workdir: str | None = None,
                 n_devices: int | None = None, device="cuda"):
    """Run the full intersection for ingroup ``files`` + ``outgroup`` files
    on ``device``.

    Returns a list of FlankGroup in deterministic sorted-key order, equal to
    ``krisp_tpu.engine.pipeline.run_pipeline``'s.  ``ingroup_filter``
    defaults to the reference's gate: filter iff there is a diagnostic
    region and an outgroup.  ``workdir`` (a table cache to resume from) or
    an input past the device-memory budget takes the staged path; past the
    budget without ``workdir`` the tables go to a temporary directory that
    is removed when the run ends.  ``n_devices`` > 1 is not ported yet and
    raises.
    """
    dev = resolve_device(device)
    if n_devices is not None and n_devices > 1:
        raise NotImplementedError(
            "more than one device is not ported yet (ROADMAP.md Queue 1, "
            "item 12: multi-GPU)")
    all_files = list(files) + list(outgroup)
    n_files = len(all_files)
    if ingroup_filter is None:
        ingroup_filter = geom.mid > 0 and len(outgroup) > 0
    epilogue = ([simple_name(f) for f in all_files],
                frozenset(simple_name(f) for f in files), len(outgroup) > 0,
                ingroup_filter)

    with METRICS.stage("read_fasta"):
        buffers = [load_buffer(path) for path in all_files]
    layout = KeyLayout(geom.left, geom.mid, geom.right, detect_bits(buffers),
                       n_files)
    tmp_workdir = None
    if workdir is None and over_budget(buffers):
        workdir = tmp_workdir = tempfile.mkdtemp(prefix="krisp_tpu_tables_")

    if workdir is None:
        # the table goes into global_stage in a list and is freed there as
        # soon as the stage is done with it
        table = [_fused_table(buffers, layout, geom, omit_soft, dev)]
        del buffers
        words, counts, gid, _ = global_stage(table, layout, n_files)
        with METRICS.stage("pull", items=gid.numel()):
            words_h = np.ascontiguousarray(keys_to_numpy(words).T)
            cnt_h = counts.cpu().numpy().astype(np.uint32)
            gid_h = gid.cpu().numpy().astype(np.int64)
        return _decode_and_group(words_h, cnt_h, gid_h, layout, geom,
                                 *epilogue)

    # staged: every geometry and both encodings, no prefilter, as krisp_tpu;
    # each genome is read again, chunk by chunk
    del buffers
    try:
        parts = _cached_parts(all_files, geom, layout.bits, omit_soft,
                              workdir, layout, device=dev)
        with METRICS.stage("intersect", device=dev):
            words_h, cnt_h, gid_h = partitioned_global_intersect(
                parts, layout, n_files, device=dev)
        del parts
    finally:
        if tmp_workdir is not None:
            shutil.rmtree(tmp_workdir, ignore_errors=True)
    return _decode_and_group(words_h, cnt_h, gid_h, layout, geom, *epilogue)


def _group_epilogue(n_keep, gid_h, mid_dec, flank_dec, fid_h, cnt_h, geom,
                    tags, ingroup_tags, has_outgroup, ingroup_filter):
    """Host epilogue: decode survivor rows into FlankGroup objects + the
    ingroup filter."""
    with METRICS.stage("decode+group"):
        render_ingroup = frozenset(ingroup_tags) if has_outgroup else None

        # rows arrive (flank, file, mid-within-file); rebuild each group in
        # mid order so amplicon insertion order matches the reference's
        # sorted-file stream
        groups: list[FlankGroup] = []
        by_gid: dict[int, list] = {}
        order: list[int] = []
        for row_i in range(n_keep):
            g = int(gid_h[row_i])
            if g not in by_gid:
                by_gid[g] = []
                order.append(g)
            by_gid[g].append(row_i)
        for g in order:
            rows = sorted(by_gid[g], key=lambda i: (mid_dec[i], i))
            flank = flank_dec[rows[0]]
            left = flank[:geom.left]
            right = flank[geom.left:]
            grp = FlankGroup(left=left, right=right, ingroup=render_ingroup)
            for i in rows:
                grp.add(KmerAmplicon(left=left, mid=mid_dec[i], right=right,
                                     label_counts={tags[int(fid_h[i])]:
                                                   int(cnt_h[i])}))
            groups.append(grp)

    if ingroup_filter:
        # Diagnostic ingroup-unique-column filter on the survivor set
        # (parity: filterAlignments.py:4-40 over Amplicon.py:495-521).
        groups = [g for g in groups if g.ingroup_unique_columns()]
    return groups
