"""End-to-end krisp_fasta search on one device
(``krisp_tpu/engine/pipeline.py``, the single-device branches).

  FASTA -> uint8 buffers -> per genome: 2-bit keys: host 2-bit pack +
  validity bitmap, upload, window keys of both strands (CUDA kernel);
  4-bit (IUPAC) keys: upload the bytes, window keys in torch ops -> one
  table -> global stage -> pull -> host decode -> FlankGroup objects.

The global stage is sort (CUDA kernel) -> survivor scan (CUDA kernel) ->
compaction; wide keys (more than 2 words and a flank of 32 bits or more)
first pass the one-word prefix prefilter and run that stage on the rows it
keeps.

``KmerGeometry``, ``solve_geometry``, ``detect_bits``,
``_pack_genomes_host``, ``_encoding_tables`` and ``_group_epilogue`` are
copies of krisp_tpu's JAX-free helpers (pinned equal by
tests/test_torch_encode.py).  Inputs that krisp_tpu sends down a branch the
port lacks raise ``NotImplementedError`` naming the ROADMAP.md item that
ports it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from krisp_tpu import dna
from krisp_tpu.engine.groups import FlankGroup, KmerAmplicon
from krisp_tpu.io.fasta import bucket_size, load_buffer, simple_name

from ..convert import keys_from_numpy, keys_to_numpy
from ..device import resolve_device
from ..metrics import GLOBAL as METRICS
from ..ops.encode import KeyLayout
from ..ops.intersect import (extract_keys_ascii, extract_keys_packed_in,
                             global_stage)

#: krisp_tpu's default KRISP_TPU_HBM_BUDGET: past it krisp_tpu takes the
#: staged out-of-core path, which the port does not have yet
HBM_BUDGET = 8 << 30


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


def genome_key_tables(paths, geom: KmerGeometry, omit_soft: bool = False,
                      device="cuda"):
    """The path up to the global stage: read the FASTA ``paths``, refuse
    inputs past the device-memory budget, pad every genome to one bucket,
    then per genome extract its sentinel-marked keys (both strands, genome
    id = its index in ``paths``) into one table.  2-bit keys are packed on
    the host and uploaded at 3 bits a base; 4-bit keys (any IUPAC letter in
    any genome) upload the bytes as they are.

    Returns (int32[W, n_files * 2 n_win] table, KeyLayout)."""
    dev = resolve_device(device)
    n_files = len(paths)
    with METRICS.stage("read_fasta"):
        buffers = [load_buffer(path) for path in paths]
    bits = detect_bits(buffers)
    layout = KeyLayout(geom.left, geom.mid, geom.right, bits, n_files)
    if 56 * 2 * sum(bucket_size(b.size) for b in buffers) > HBM_BUDGET:
        raise NotImplementedError(
            "inputs past the device-memory budget need the out-of-core path, "
            "which is not ported yet (ROADMAP.md Queue 1, item 9: "
            "out-of-core)")

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
                rows.copy_(extract_keys_packed_in(
                    pk, vb, f, geom.left, geom.mid, geom.right, bits,
                    n_files))
        else:
            with METRICS.stage("upload", items=pad, device=dev):
                buf = torch.from_numpy(stacked[f]).to(dev)
            with METRICS.stage("extract", items=n_win, device=dev):
                rows.copy_(extract_keys_ascii(
                    buf, f, tables, geom.left, geom.mid, geom.right, bits,
                    n_files))
    return flat, layout


def run_pipeline(files, outgroup, geom: KmerGeometry, omit_soft: bool = False,
                 ingroup_filter: bool | None = None, workdir: str | None = None,
                 n_devices: int | None = None, device="cuda"):
    """Run the full intersection for ingroup ``files`` + ``outgroup`` files
    on ``device``.

    Returns a list of FlankGroup in deterministic sorted-key order, equal to
    ``krisp_tpu.engine.pipeline.run_pipeline``'s.  ``ingroup_filter``
    defaults to the reference's gate: filter iff there is a diagnostic
    region and an outgroup.  ``workdir`` (out-of-core tables) and
    ``n_devices`` > 1 are not ported yet and raise.
    """
    dev = resolve_device(device)
    if workdir is not None:
        raise NotImplementedError(
            "workdir (out-of-core k-mer tables) is not ported yet "
            "(ROADMAP.md Queue 1, item 9: out-of-core)")
    if n_devices is not None and n_devices > 1:
        raise NotImplementedError(
            "more than one device is not ported yet (ROADMAP.md Queue 1, "
            "item 12: multi-GPU)")
    all_files = list(files) + list(outgroup)
    n_files = len(all_files)
    tags = [simple_name(f) for f in all_files]
    ingroup_tags = frozenset(simple_name(f) for f in files)
    has_outgroup = len(outgroup) > 0
    if ingroup_filter is None:
        ingroup_filter = geom.mid > 0 and has_outgroup

    # the table goes into global_stage in a list and is freed there as
    # soon as the stage is done with it
    table, layout = genome_key_tables(all_files, geom, omit_soft, dev)
    table = [table]
    bits = layout.bits
    words, counts, gid, _ = global_stage(table, layout, n_files)
    with METRICS.stage("pull", items=gid.numel()):
        words_h = np.ascontiguousarray(keys_to_numpy(words).T)
        cnt_h = counts.cpu().numpy().astype(np.uint32)
        gid_h = gid.cpu().numpy().astype(np.int64)
    n_keep = gid_h.size

    off_flank, off_mid = layout.base_offsets()
    flank_dec = dna.decode_bits(words_h, off_flank, bits)
    mid_dec = (dna.decode_bits(words_h, off_mid, bits) if geom.mid > 0
               else [""] * n_keep)
    fid_h = dna.extract_bit_field(words_h, layout.file_off, layout.file_bits)
    return _group_epilogue(n_keep, gid_h, mid_dec, flank_dec, fid_h, cnt_h,
                           geom, tags, ingroup_tags, has_outgroup,
                           ingroup_filter)


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
