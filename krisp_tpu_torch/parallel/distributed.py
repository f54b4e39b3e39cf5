"""The sharded krisp_fasta intersection over a mesh of devices
(``krisp_tpu/parallel/distributed.py``).

A mesh (``Mesh``) is an ordered list of shards, each run on a torch device.
In one process a device may repeat: ``[cpu] * n`` or ``[cuda:0] * n`` are n
shards that each run the real code, exchanging rows by device copies.
Across processes (``multihost.pod_mesh``) each process runs one shard and
the same steps exchange rows through ``torch.distributed``: NCCL carries
CUDA tensors, gloo CPU tensors, and no CUDA tensor goes through the host
for a collective.

The layout is krisp_tpu's:

  - **sequence parallelism**: shard s owns the window starts of its slice
    of every genome buffer; the next shard's first ``L - 1`` bytes (the
    halo) complete the windows that cross the boundary, and the last shard
    gets zeros, so every window is counted once;
  - **key-range ownership**: a row goes to the shard that owns the top bits
    of its key word 0 (``_owner_of``, monotone in the key), so every flank
    group is whole on one owner and the concatenation of the owners'
    results in shard order is the globally sorted survivor table;
  - **per-owner survivor scan**: each owner runs the single-device scan on
    its range; group ids are offset per shard (``assemble_compacted``), so
    they equal krisp_tpu's sharded ids, not the single-device ones.

Per shard: window keys (the window-key kernel's table mode for 2-bit keys,
torch ``window_keys_bits`` for 4-bit), the sort kernel over all W words
(sentinel rows last, so each destination's rows are one contiguous sorted
run), the exchange, a pairwise tree of merge-kernel calls over the runs
received, then the scan kernel in layout mode and compaction.  Each step
runs over every shard before the next starts, so the cards work side by
side, and is a stage of ``metrics.GLOBAL`` of its own.

The exchange ships exact splits: the per-destination row counts go first,
then each run once (``all_to_all_single`` with split sizes across
processes, per-destination slices copied to their device in one process).
No row is dropped, so krisp_tpu's padded ``all_to_all`` capacity and its
overflow retry have no counterpart.  The kernels take fewer than
``budget.ROW_LIMIT`` rows: each owner's rows are summed over every shard
before the exchange, and an owner at the limit raises.

``sharded_kmer_step`` is krisp_tpu's per-shard unique k-mer table with
genome ids and counts, on the same transport, over ``ops.encode.kmer_keys``
and ``ops.sort.build_sorted_unique``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import budget, dna
from ..convert import keys_to_numpy
from ..device import devices_for_run, resolve_device
from ..metrics import GLOBAL as METRICS
from ..ops.encode import KeyLayout, kmer_keys, num_words
from ..ops.intersect import _all_window_keys, compact_rows
from ..ops.merge import merge_sorted_words
from ..ops.scan import survivor_scan_layout, valid_rows
from ..ops.sort import build_sorted_unique, sort_words


class Mesh:
    """An ordered list of shards and the devices that run them.

    In one process (``group`` None) shard i runs on ``devices[i]``; a device
    may repeat.  With a process group this process runs the one shard
    ``rank`` of ``size`` on ``devices[0]``, and ``grid`` holds the ranks by
    (host, local) (``multihost.pod_mesh``).  The collectives below are the
    only places where shards meet; every sharded function runs its
    per-shard steps over ``local`` and calls them."""

    def __init__(self, devices, group=None, rank: int = 0,
                 world_size: int | None = None, grid=None):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.group = group
        self.rank = rank
        self.size = len(self.devices) if group is None else int(world_size)
        self.grid = grid

    def __repr__(self):
        where = (f"rank {self.rank} of {self.size}" if self.group is not None
                 else f"{self.size} shards")
        return f"Mesh({where}, {[str(d) for d in self.devices]})"

    @property
    def local(self):
        """(shard, device) of every shard this process runs."""
        if self.group is None:
            return list(enumerate(self.devices))
        return [(self.rank, self.devices[0])]

    @property
    def device(self):
        """The device that assembled results lie on."""
        return self.devices[0]

    def next_heads(self, heads: dict) -> dict:
        """{shard: tensor} of this process's shards, all of one shape ->
        {shard: the next shard's tensor}; the last shard gets zeros."""
        if self.group is None:
            return {s: (heads[s + 1].to(dev) if s + 1 < self.size
                        else torch.zeros_like(heads[s]))
                    for s, dev in self.local}
        import torch.distributed as dist
        (s, h), = heads.items()
        got = [torch.empty_like(h) for _ in range(self.size)]
        dist.all_gather(got, h.contiguous(), group=self.group)
        return {s: got[s + 1] if s + 1 < self.size else torch.zeros_like(h)}

    def all_to_all(self, sends: dict) -> dict:
        """{shard: [rows for destination d, for d in range(size)]}, each an
        int32[V, m_d] table, -> {shard: [rows from source s, in source
        order]} on the shard's device.  The counts go first, then each run
        once, at its exact size."""
        if self.group is None:
            return {d: [sends[s][d].to(dev) for s in range(self.size)]
                    for d, dev in self.local}
        import torch.distributed as dist
        (s, parts), = sends.items()
        dev, V = self.devices[0], parts[0].shape[0]
        sizes = [p.shape[1] for p in parts]
        counts = torch.tensor(sizes, dtype=torch.int64, device=dev)
        recv_counts = torch.empty_like(counts)
        dist.all_to_all_single(recv_counts, counts, group=self.group)
        recv_sizes = recv_counts.tolist()
        send = torch.cat([p.T for p in parts]).contiguous()   # [rows, V]
        recv = torch.empty((sum(recv_sizes), V), dtype=send.dtype,
                           device=dev)
        dist.all_to_all_single(recv, send, recv_sizes, sizes,
                               group=self.group)
        return {s: [r.T for r in recv.split(recv_sizes)]}

    def gather(self, parts: dict) -> list:
        """{shard: [V, m_s] table} -> every shard's table in shard order,
        on ``device``, in every process."""
        if self.group is None:
            return [parts[s].to(self.device) for s in range(self.size)]
        import torch.distributed as dist
        (s, t), = parts.items()
        n = torch.tensor([t.shape[1]], dtype=torch.int64, device=t.device)
        sizes = [torch.empty_like(n) for _ in range(self.size)]
        dist.all_gather(sizes, n, group=self.group)
        sizes = [int(x) for x in torch.cat(sizes).tolist()]
        padded = t.new_zeros((max(sizes), t.shape[0]))
        padded[:t.shape[1]] = t.T
        got = [torch.empty_like(padded) for _ in range(self.size)]
        dist.all_gather(got, padded, group=self.group)
        return [g[:m].T for g, m in zip(got, sizes)]

    def all_true(self, flag: bool) -> bool:
        """Whether ``flag`` holds in every process of the group (in one
        process, ``flag``): a decision every process then takes alike."""
        if self.group is None:
            return bool(flag)
        import torch.distributed as dist
        t = torch.tensor([int(bool(flag))], dtype=torch.int64,
                         device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=self.group)
        return bool(t.item())

    def all_reduce_sum(self, parts: dict) -> torch.Tensor:
        """{shard: tensor} -> the elementwise sum over every shard, on
        ``device``.  Exact for integer tensors."""
        if self.group is None:
            total = parts[0].to(self.device).clone()
            for s in range(1, self.size):
                total += parts[s].to(self.device)
            return total
        import torch.distributed as dist
        (s, t), = parts.items()
        t = t.clone()
        dist.all_reduce(t, group=self.group)
        return t


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A mesh over ``devices`` (any torch devices, repeats allowed), else
    over the first ``n_devices`` CUDA devices (default: all of them).  A
    CUDA device without CUDA raises."""
    if devices is None:
        present = torch.cuda.device_count()
        n = present if n_devices is None else int(n_devices)
        if n > present:
            raise ValueError(f"{n} CUDA devices asked for, {present} present")
        devices = [f"cuda:{i}" for i in range(n)]
    elif n_devices is not None:
        devices = list(devices)[:n_devices]
    return Mesh([resolve_device(d) for d in devices])


def mesh_from_env(n_devices: int | None = None,
                  device="cuda") -> Mesh | None:
    """The device-mesh gate shared by the three verticals: the devices of
    ``device``'s type counted as ``device.devices_for_run`` counts them
    (``n_devices``, else ``KRISP_TPU_DEVICES``, else all present).  None
    for one device (callers take their single-device path).  A mesh built
    here never repeats a device."""
    n = devices_for_run(n_devices, resolve_device(device))
    return None if n <= 1 else make_mesh(n)


def _halo_exchange(mesh: Mesh, blocks: dict, halo: int) -> dict:
    """Append the next shard's first ``halo`` columns to each shard's block
    ({shard: uint8[..., chunk]}); the last shard gets zero bytes (NUL, an
    invalid base), so no window is made up past the end of the genome."""
    if halo == 0:
        return blocks
    heads = mesh.next_heads({s: b[..., :halo].contiguous()
                             for s, b in blocks.items()})
    return {s: torch.cat([b, heads[s]], dim=-1) for s, b in blocks.items()}


def _owner_of(w0: torch.Tensor, valid: torch.Tensor, n_shards: int,
              t: int) -> torch.Tensor:
    """Monotone range partition of keys onto shards by the top ``t`` bits of
    key word 0 (int32 holding the u32 bits): owner = floor(top * n_shards /
    2**t), krisp_tpu's map.  The word is widened to int64 and masked, so a
    word with its top bit set gives its unsigned top bits.  Invalid rows map
    to ``n_shards``."""
    top = (w0.to(torch.int64) & 0xFFFFFFFF) >> (32 - t)
    owner = (top * n_shards) >> t
    return torch.where(valid, owner, n_shards)


def merge_runs(runs) -> torch.Tensor:
    """One sorted int32[V, n] table from sorted runs of one V: the merge
    kernel in a pairwise tree, an odd run carried up a level unchanged.
    Empty runs are dropped first; equal rows are identical, so the order
    of ties does not show."""
    runs = [r for r in runs if r.shape[1]]
    if not runs:
        raise ValueError("merge_runs needs at least one non-empty run")
    while len(runs) > 1:
        nxt = [merge_sorted_words(runs[i], runs[i + 1])
               for i in range(0, len(runs) - 1, 2)]
        if len(runs) % 2:
            nxt.append(runs[-1])
        runs = nxt
    return runs[0].contiguous()


def _encoding_tables(bits: int, omit_soft: bool):
    if bits == 2:
        return None        # the window-key kernel needs no table
    return (dna.CODE4_TABLE,
            dna.base_validity_table(bits, disallow="Nn", omit_soft=omit_soft),
            dna.COMP4_TABLE)


def _upload_slices(mesh: Mesh, array: np.ndarray, chunk: int) -> dict:
    """{shard: the shard's slice [..., s*chunk:(s+1)*chunk] of ``array``
    on its device}, for this process's shards."""
    return {s: torch.from_numpy(np.ascontiguousarray(
        array[..., s * chunk:(s + 1) * chunk])).to(dev)
        for s, dev in mesh.local}


def _owner_counts(mesh: Mesh, keys: dict, layout: KeyLayout,
                  t_owner: int) -> dict:
    """{shard: [rows of its sorted ``keys`` each owner receives]}.  A
    shard's owners are non-decreasing down its sorted table (sentinel rows
    last, mapped past every owner), so each owner's rows are one run and
    its count is a difference of run starts; every shard's starts are
    queued before any is read back, so the cards map their rows side by
    side."""
    n = mesh.size
    starts = {}
    for s, dev in mesh.local:
        owner = _owner_of(keys[s][0], valid_rows(keys[s], layout), n,
                          t_owner)
        starts[s] = torch.searchsorted(
            owner, torch.arange(n + 1, dtype=torch.int64, device=dev))
        del owner
    return {s: torch.diff(b).tolist() for s, b in starts.items()}


def _check_owner_rows(mesh: Mesh, counts: dict) -> None:
    """Raise where an owner would receive ``budget.ROW_LIMIT`` rows or
    more (the kernels' 32-bit row ids), before the exchange allocates
    anything: each owner's rows summed over every shard's ``counts``.
    The limit is read at call time."""
    total = mesh.all_reduce_sum({
        s: torch.tensor(counts[s], dtype=torch.int64, device=dev)
        for s, dev in mesh.local})
    limit = budget.ROW_LIMIT
    for d, rows in enumerate(total.tolist()):
        if rows >= limit:
            raise RuntimeError(
                f"shard {d} would receive {rows} rows; the sort, merge and "
                f"scan kernels take fewer than {limit} "
                "(budget.ROW_LIMIT)")


def sharded_intersect_pipeline(mesh: Mesh, stacked: np.ndarray, left: int,
                               mid: int, right: int, bits: int,
                               omit_soft: bool = False):
    """The full intersection over ``mesh``.

    stacked: uint8[n_files, P] genome buffers, P a multiple of the mesh
    size (the caller pads); with a process group every process passes the
    same array and uploads its own slice.  Returns (words uint32[n_keep,
    W], counts uint32[n_keep], gid int64[n_keep]) in every process:
    krisp_tpu's ``sharded_intersect_pipeline`` rows, counts and ids (the
    single-device fused rows and counts; ids offset per shard).

    Each step is a stage of ``metrics.GLOBAL`` that runs over every shard
    of this process before the next step starts, and waits at its end for
    every device it queued work on: ``upload`` (bytes of the slices and
    their halos), ``extract`` (windows keyed), ``sort`` (rows sorted),
    ``owner`` (rows mapped to their owners and split), ``exchange`` (rows
    sent to another shard), ``merge`` (rows the owners received and
    merged), ``scan`` (rows scanned, with the compaction) and ``pull``
    (survivor rows gathered to the host and assembled).  An owner that
    would receive ``budget.ROW_LIMIT`` rows or more raises a
    ``RuntimeError`` at the end of ``owner``, before the exchange."""
    n_files, P = stacked.shape
    n = mesh.size
    assert P % n == 0
    chunk = P // n
    L = left + mid + right
    assert chunk >= L, "per-shard slice shorter than the window length"
    layout = KeyLayout(left, mid, right, bits, n_files)
    W = layout.n_words
    bbits = max((n - 1).bit_length(), 1)
    assert layout.flank_bits >= bbits or n == 1, (
        "flank too short to key-range partition across this many devices")
    t_owner = min(10, layout.flank_bits, 32)
    tables = _encoding_tables(bits, omit_soft)
    n_rows = 2 * chunk          # both strands of a genome's chunk windows
    local = mesh.local
    devices = list(dict.fromkeys(dev for _, dev in local))
    rows = len(local) * n_files * n_rows     # every local shard's table

    with METRICS.stage("upload", items=len(local) * n_files * (chunk + L - 1),
                       device=devices):
        blocks = _halo_exchange(mesh, _upload_slices(mesh, stacked, chunk),
                                L - 1)
    with METRICS.stage("extract", items=rows, device=devices):
        keys = {}
        for s, dev in local:
            table = torch.empty((W, n_files * n_rows), dtype=torch.int32,
                                device=dev)
            for f in range(n_files):
                _all_window_keys(blocks[s][f], f, left, mid, right, bits,
                                 n_files, tables, omit_soft,
                                 out=table[:, f * n_rows:(f + 1) * n_rows])
            keys[s] = table
        del blocks, table
    with METRICS.stage("sort", items=rows, device=devices):
        for s, _ in local:
            keys[s] = sort_words(keys[s])
    with METRICS.stage("owner", items=rows, device=devices):
        counts = _owner_counts(mesh, keys, layout, t_owner)
        _check_owner_rows(mesh, counts)
        sends = {s: list(keys[s][:, :sum(c)].split(c, dim=1))
                 for s, c in counts.items()}
    del keys
    moved = sum(m for s, c in counts.items()
                for d, m in enumerate(c) if d != s)
    with METRICS.stage("exchange", items=moved, device=devices):
        received = mesh.all_to_all(sends)
        del sends
    got = {s: sum(r.shape[1] for r in runs) for s, runs in received.items()}
    with METRICS.stage("merge", items=sum(got.values()), device=devices):
        merged = {s: merge_runs(received.pop(s)) if got[s] else None
                  for s, _ in local}
    with METRICS.stage("scan", items=sum(got.values()), device=devices):
        out = {}
        for s, dev in local:
            table = merged.pop(s)
            if table is None:
                out[s] = torch.zeros((W + 2, 0), dtype=torch.int32,
                                     device=dev)
                continue
            keep, cnt, gid = survivor_scan_layout(table, layout, n_files)
            (words, cnt, gid), _ = compact_rows([table, cnt, gid], keep)
            del table, keep
            out[s] = torch.cat([words, cnt[None], gid[None]])
    with METRICS.stage("pull", device=devices) as stat:
        parts = [keys_to_numpy(p) for p in mesh.gather(out)]
        del out
        nk = np.array([p.shape[1] for p in parts], np.int64)
        cap = max(int(nk.max()), 1)
        packed = np.zeros((W + 2, n * cap), np.uint32)
        for s, p in enumerate(parts):
            packed[:, s * cap:s * cap + p.shape[1]] = p
        stat.items += int(nk.sum())
        return assemble_compacted(packed[:W], packed[W],
                                  packed[W + 1].astype(np.int64), nk, cap, n)


def assemble_compacted(words, cnts, gids, nk, cap: int, n_shards: int):
    """Concatenate per-shard compacted survivor rows (shard order = key
    order) with globally unique, order-preserving group ids (krisp_tpu's,
    verbatim but for this docstring).  Every process of a process-group
    mesh runs it on the gathered shards."""
    rows_w, rows_c, rows_g = [], [], []
    gid_off = 0
    for s in range(n_shards):
        k = int(nk[s])
        if k == 0:
            continue
        sl = slice(s * cap, s * cap + k)
        rows_w.append(words[:, sl])
        rows_c.append(cnts[sl])
        g = gids[sl].astype(np.int64) + gid_off
        gid_off = int(g[-1]) + 1
        rows_g.append(g)
    if not rows_w:
        W = words.shape[0]
        return (np.zeros((0, W), np.uint32), np.zeros(0, np.uint32),
                np.zeros(0, np.int64))
    return (np.concatenate(rows_w, axis=1).T, np.concatenate(rows_c),
            np.concatenate(rows_g))


def sharded_kmer_step(mesh: Mesh, left: int, mid: int, right: int,
                      bits: int, n_files: int):
    """krisp_tpu's ``sharded_kmer_step`` on ``mesh``: returns ``step``, which
    maps uint8[n_files, n_shards * chunk] buffers to every shard's sorted
    unique table of its key range, with each row's genome id and count.

    Per shard and genome: the halo, ``kmer_keys`` (both strands, the bits
    permuted as ``sort_perm`` orders them) and ``build_sorted_unique``;
    then the genomes' tables sort together, each row goes to the owner of
    its leading key bits and the owner sorts what it received.  Rows are
    (invalid, words, genome id, count); exact splits, so no row is dropped
    and the overflow count is always 0.  ``step(buffers)`` returns (invalid
    int32[m], words int32[W, m], genome ids int32[m], counts int32[m],
    total valid rows, overflow) over every shard's rows in shard order: the
    rows krisp_tpu's step returns, without its padding rows."""
    L = left + mid + right
    W = num_words(L, bits)
    n = mesh.size
    code_table = dna.CODE2_TABLE if bits == 2 else dna.CODE4_TABLE
    comp_table = dna.COMP2_TABLE if bits == 2 else dna.COMP4_TABLE
    valid_table = dna.base_validity_table(bits, disallow="Nn")
    t_owner = min(10, L * bits, 32)

    def step(buffers: np.ndarray):
        chunk = buffers.shape[1] // n
        blocks = _halo_exchange(mesh, _upload_slices(mesh, buffers, chunk),
                                L - 1)
        sends = {}
        for s, dev in mesh.local:
            rows = []
            for f in range(n_files):
                invalid, words = kmer_keys(blocks[s][f], code_table,
                                           valid_table, comp_table, left,
                                           mid, right, bits)
                u_inv, u_words, u_cnt, nu = build_sorted_unique(
                    invalid, words, bits)
                fid = torch.full((nu,), f, dtype=torch.int32, device=dev)
                rows.append(torch.stack([*(w[:nu] for w in u_words), fid,
                                         u_cnt[:nu]]))
            # the valid rows of every genome in key order; (id, count)
            # trail the key, and no two rows share a (key, id)
            table = sort_words(torch.cat(rows, dim=1))
            owner = _owner_of(table[0], torch.ones_like(table[0],
                                                        dtype=torch.bool),
                              n, t_owner)
            counts = torch.bincount(owner, minlength=n).tolist()
            sends[s] = list(table.split(counts, dim=1))
        received = mesh.all_to_all(sends)
        out = {s: sort_words(torch.cat(received[s], dim=1))
               for s, _ in mesh.local}
        parts = mesh.gather(out)
        table = torch.cat(parts, dim=1)
        m = table.shape[1]
        invalid = torch.zeros(m, dtype=torch.int32, device=table.device)
        return (invalid, table[:W], table[W], table[W + 1], m, 0)

    return step
