"""End-to-end krisp_fasta search on one device
(``krisp_tpu/engine/pipeline.py``, the single-device branches).

Fused path (the whole key table on the card at once):

  FASTA -> uint8 buffers -> per genome: upload the bytes, window keys of
  both strands (2-bit keys: the window-key CUDA kernel on the bytes;
  4-bit (IUPAC) keys: torch ops) -> one table -> global stage -> pull ->
  host decode -> FlankGroup objects.

The global stage is sort (CUDA kernel) -> survivor scan (CUDA kernel) ->
compaction; wide keys (more than 2 words and a flank of 32 bits or more)
first pass the one-word prefix prefilter and run that stage on the rows it
keeps.

Staged (out-of-core) path, taken with a ``workdir`` or where the fused
path does not fit (``takes_fused``: on a card its table, over a mesh each
shard's, must hold fewer rows than the kernels take and its peak,
``fused_charge``, must fit the card's budget, ``budget.device_budget``;
on the CPU krisp_tpu's rule, 56 bytes a window against
``KRISP_TPU_HBM_BUDGET``, default 8 GiB; over a process group every
process takes the route that all of them fit):

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
copies of krisp_tpu's host modules.

Sharded path: the device count is krisp_tpu's (``n_devices``, else
``KRISP_TPU_DEVICES``, else all, clamped to the devices present); over
more than one device, where the flank holds the key-range owner bits, the
fused path runs ``parallel.distributed.sharded_intersect_pipeline`` over a
mesh of the cards (``_mesh_for_run``), or over the ``mesh`` the caller
passes (a mesh may repeat a device).

Every host step of a fused search is a stage of ``metrics.GLOBAL`` beside
the device stages, none inside another: ``read_fasta`` (bytes whose
encoding width the native reader gave), ``detect_bits`` (bytes of every
genome), ``stack`` (bytes of the padded array), ``upload``
(padded bytes a genome), ``extract`` (windows a genome), ``pull``,
``decode`` (survivor rows), ``decode+group`` (survivor rows) and
``filter`` (groups examined); the CLI adds ``render``.  The sharded
path's steps are stages too (``parallel.distributed``): ``upload``,
``extract``, ``sort``, ``owner``, ``exchange``, ``merge``, ``scan`` and
``pull``, each over every shard before the next begins.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from collections import Counter
from dataclasses import dataclass

import numpy as np
import torch

from .. import dna
from ..budget import (COMPACT_ROW_BYTES, KRISP_TPU_WINDOW_BYTES,
                      OWNER_ROW_BYTES, PREFILTER_ROW_BYTES, ROW_LIMIT,
                      device_budget, device_charge, sort_row_bytes,
                      table_bytes)
from ..convert import keys_to_numpy
from ..device import devices_for_run, resolve_device
from ..io.fasta import bucket_size, genome_bits, load_buffer, simple_name
from ..metrics import GLOBAL as METRICS
from ..ops.encode import KeyLayout
from ..ops.intersect import (_all_window_keys, compact_rows, dedup_sorted,
                             global_stage, prefilter_gate)
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


def _shard_chunk(sizes, L: int, n_shards: int) -> int:
    """krisp_tpu's slice of a genome a shard: the largest genome over the
    shard count, at least the window, rounded up to 1024."""
    chunk = max(-(-max(sizes) // n_shards), L)
    return -(-chunk // 1024) * 1024


def fused_charge(sizes, layout: KeyLayout, L: int,
                 n_shards: int | None = None):
    """(rows, bytes) of the fused search on a card over genomes of
    ``sizes`` bases at window length ``L``.  One device (``n_shards``
    None): the rows of the table as ``_fused_table`` allocates them (every
    genome padded to the largest one's bucket, both strands) and the
    device's peak: the sort, the compaction with every row a survivor
    and, where the prefilter runs, its temporaries and its gather.  A mesh
    of ``n_shards`` shards: one shard's rows and one shard's peak.  The
    rows are its table as ``_sharded`` allocates it (every genome padded
    to ``n_shards`` slices), which its extraction, sort and owner split
    hand a kernel, and also an owner's even share of the key range; the
    peak is the sort, the owner computation, the merge of the runs it
    receives (the runs, a level of the merge tree and the merged run) and
    the compaction, for that share (``budget.table_bytes``).  An owner
    that would receive more is refused by the exchange's own guard
    (``parallel.distributed``).  Nothing is allocated."""
    W, n_files = layout.n_words, len(sizes)
    compact = 2 * 4 * W + COMPACT_ROW_BYTES
    if n_shards is None:
        genome_rows = 2 * max(bucket_size(max(sizes)) - L + 1, 0)
        stages = [sort_row_bytes(W), compact]
        if prefilter_gate(layout):
            stages += [4 * W + PREFILTER_ROW_BYTES, 8 * W + 8]
        rows = n_files * genome_rows
        return rows, table_bytes(layout, rows, genome_rows, stages)
    genome_rows = 2 * _shard_chunk(sizes, L, n_shards)
    stages = [sort_row_bytes(W), 4 * W + OWNER_ROW_BYTES, 3 * 4 * W, compact]
    rows = n_files * genome_rows
    return rows, table_bytes(layout, rows, genome_rows, stages)


def takes_fused(sizes, layout: KeyLayout, L: int, dev, mesh=None) -> bool:
    """``run_pipeline``'s route, on sizes alone: whether the fused search
    over genomes of ``sizes`` bases at window length ``L`` runs on ``dev``
    (or over ``mesh``), else the staged path.  Each device the run uses
    must fit its charge (``budget.device_charge``) in its budget
    (``budget.device_budget``): on a card, a table of fewer than
    ``budget.ROW_LIMIT`` rows (over a mesh each shard's own table, the
    rows a kernel is handed) whose peak (``fused_charge``; of every shard
    the device runs) fits; on the CPU krisp_tpu's rule,
    ``KRISP_TPU_WINDOW_BYTES`` a window of each genome's own bucket.  Over
    a process group every process takes the fused path only if all of
    them fit it, so that no process waits in a collective that another
    never calls."""
    cpu = KRISP_TPU_WINDOW_BYTES * 2 * sum(bucket_size(s) for s in sizes)
    if mesh is None:
        rows, card = fused_charge(sizes, layout, L)
        shards = {dev: 1}
    else:
        rows, card = fused_charge(sizes, layout, L, mesh.size)
        shards = Counter(d for _, d in mesh.local)
    ok = True
    for d, k in shards.items():
        r, charge = device_charge(d, rows, card * k, cpu)
        ok &= r < ROW_LIMIT and charge <= device_budget(d)
    return ok if mesh is None else mesh.all_true(ok)


def _read_genomes(paths):
    """The genome buffers of the FASTA ``paths`` and the per-base encoding
    width they take (``detect_bits``'s answer: the widest of the widths
    ``genome_bits`` gives the buffers, the native reader's own where it read
    them).  Stage ``read_fasta`` counts the bytes whose width the native
    reader gave."""
    with METRICS.stage("read_fasta") as read:
        buffers = [load_buffer(path) for path in paths]
        widths = [genome_bits(buf) for buf in buffers]
        read.items += sum(buf.size for buf, (_, by_reader)
                          in zip(buffers, widths) if by_reader)
    with METRICS.stage("detect_bits", items=sum(b.size for b in buffers)):
        bits = max(b for b, _ in widths)
    return buffers, bits


def _stack(buffers, width: int) -> np.ndarray:
    """Every genome buffer zero-padded to ``width`` bases:
    uint8[n_files, width]."""
    with METRICS.stage("stack", items=len(buffers) * width):
        stacked = np.zeros((len(buffers), width), np.uint8)
        for i, buf in enumerate(buffers):
            stacked[i, :buf.size] = buf
    return stacked


def _fused_table(buffers, layout: KeyLayout, geom: KmerGeometry,
                 omit_soft: bool, dev):
    """Pad every genome buffer to one bucket, then per genome upload its
    bytes as they are and extract its sentinel-marked keys (both strands,
    genome id = its index) into one table: 2-bit keys through the
    window-key kernel's table mode, whose arithmetic validity equals
    ``dna.base_validity_table(2, "Nn", omit_soft)`` on every byte a 2-bit
    input holds; 4-bit keys (any IUPAC letter in any genome) through
    ``window_keys_bits`` with the tables of ``_encoding_tables``.  Returns
    int32[W, n_files * 2 n_win]."""
    stacked = _stack(buffers, bucket_size(max(b.size for b in buffers)))
    n_files, pad = stacked.shape
    n_win = 2 * (pad - geom.total + 1)
    # one table filled genome by genome: no per-genome tables to concatenate
    flat = torch.empty((layout.n_words, n_files * n_win), dtype=torch.int32,
                       device=dev)
    tables = _encoding_tables(layout.bits, omit_soft)
    for f in range(n_files):
        with METRICS.stage("upload", items=pad, device=dev):
            buffer = torch.from_numpy(stacked[f]).to(dev)
        with METRICS.stage("extract", items=n_win, device=dev):
            _all_window_keys(buffer, f, geom.left, geom.mid, geom.right,
                             layout.bits, n_files, tables, omit_soft,
                             out=flat[:, f * n_win:(f + 1) * n_win])
        del buffer
    return flat


def genome_key_tables(paths, geom: KmerGeometry, omit_soft: bool = False,
                      device="cuda"):
    """The fused path up to the global stage: read the FASTA ``paths`` and
    build their one key table.  Returns (int32[W, n_files * 2 n_win]
    table, KeyLayout)."""
    dev = resolve_device(device)
    buffers, bits = _read_genomes(paths)
    layout = KeyLayout(geom.left, geom.mid, geom.right, bits, len(paths))
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
    # a chunk's sort takes both strands' rows: fewer than the kernels' limit
    chunk_size = min(chunk_size, (ROW_LIMIT - 1) // 2)
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
    with METRICS.stage("decode", items=n_keep):
        flank_dec = dna.decode_bits(words_h, off_flank, bits)
        mid_dec = (dna.decode_bits(words_h, off_mid, bits) if geom.mid > 0
                   else [""] * n_keep)
        fid_h = dna.extract_bit_field(words_h, layout.file_off,
                                      layout.file_bits)
    return _group_epilogue(n_keep, gid_h, mid_dec, flank_dec, fid_h, cnt_h,
                           geom, tags, ingroup_tags, has_outgroup,
                           ingroup_filter)


def _mesh_for_run(layout: KeyLayout, n_dev: int):
    """krisp_tpu's mesh gate for the fused path: a mesh of ``n_dev`` cards,
    or None (the single-device path) for one device or a flank too short
    to hold the key-range owner bits."""
    if n_dev <= 1 or layout.flank_bits < max((n_dev - 1).bit_length(), 1):
        return None
    from ..parallel import distributed
    return distributed.make_mesh(n_dev)


def run_pipeline(files, outgroup, geom: KmerGeometry, omit_soft: bool = False,
                 ingroup_filter: bool | None = None, workdir: str | None = None,
                 n_devices: int | None = None, device="cuda", mesh=None):
    """Run the full intersection for ingroup ``files`` + ``outgroup`` files
    on ``device``.

    Returns a list of FlankGroup in deterministic sorted-key order, equal to
    ``krisp_tpu.engine.pipeline.run_pipeline``'s.  ``ingroup_filter``
    defaults to the reference's gate: filter iff there is a diagnostic
    region and an outgroup.  ``workdir`` (a table cache to resume from) or
    an input that the fused path does not fit (``takes_fused``) takes the
    staged path; without ``workdir`` the tables then go to a temporary
    directory that is removed when the run ends.  A device error raises:
    no route is retried on another.  ``n_devices`` (default
    ``KRISP_TPU_DEVICES``, else all) is clamped to the devices present, as
    krisp_tpu clamps it; over several devices the fused path is sharded
    (``_mesh_for_run``).  ``mesh`` (a ``parallel.distributed.Mesh``) shards
    the fused path over its devices in place of that count.  The staged
    path ignores both, as krisp_tpu's does.
    """
    dev = resolve_device(device)
    n_dev = devices_for_run(n_devices, dev)
    all_files = list(files) + list(outgroup)
    n_files = len(all_files)
    if ingroup_filter is None:
        ingroup_filter = geom.mid > 0 and len(outgroup) > 0
    epilogue = ([simple_name(f) for f in all_files],
                frozenset(simple_name(f) for f in files), len(outgroup) > 0,
                ingroup_filter)

    buffers, bits = _read_genomes(all_files)
    layout = KeyLayout(geom.left, geom.mid, geom.right, bits, n_files)
    tmp_workdir = None
    if workdir is None:
        if mesh is None:
            mesh = _mesh_for_run(layout, n_dev)
        if not takes_fused([b.size for b in buffers], layout, geom.total,
                           dev, mesh):
            workdir = tmp_workdir = tempfile.mkdtemp(
                prefix="krisp_tpu_tables_")

    if workdir is None:
        if mesh is not None:
            return _decode_and_group(*_sharded(buffers, layout, geom,
                                               omit_soft, mesh),
                                     layout, geom, *epilogue)
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


def _sharded(buffers, layout: KeyLayout, geom: KmerGeometry,
             omit_soft: bool, mesh):
    """krisp_tpu's sharded branch: the genomes padded to one chunk a shard
    (the largest genome over the shard count, at least the window, rounded
    up to 1024), then ``sharded_intersect_pipeline``, whose every step is
    a stage of its own.  Returns its (words, counts, gid) rows."""
    from ..parallel.distributed import sharded_intersect_pipeline
    n_sh = mesh.size
    chunk = _shard_chunk([b.size for b in buffers], geom.total, n_sh)
    stacked = _stack(buffers, n_sh * chunk)
    return sharded_intersect_pipeline(mesh, stacked, geom.left, geom.mid,
                                      geom.right, layout.bits,
                                      omit_soft=omit_soft)


def _group_epilogue(n_keep, gid_h, mid_dec, flank_dec, fid_h, cnt_h, geom,
                    tags, ingroup_tags, has_outgroup, ingroup_filter):
    """Host epilogue: decode survivor rows into FlankGroup objects + the
    ingroup filter."""
    with METRICS.stage("decode+group", items=n_keep):
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
        with METRICS.stage("filter", items=len(groups)):
            groups = [g for g in groups if g.ingroup_unique_columns()]
    return groups

