"""Device kstream engine on the port's kernels (``krisp_tpu/kstream_device.py``).

The reference's published kstream workloads (README.md:294-312) are
"extract all k-mers, filter, sort" over large FASTA — the exact shape of
the device engine.  This module routes eligible configurations through the
packed-key pipeline: windows (the window-key kernel at geometry (k, 0, 0))
-> (optional revcomp/canonical) -> the sort kernel -> run-length counts ->
vectorized text decode, emitting the identical byte stream the string
pipeline produces.

``DevicePlan``, ``device_plan``, ``content_ok`` and ``_embed_params`` are
copies of krisp_tpu's; ``_decode_chars`` writes the same bytes 8 bases a
gather; ``mode_keys``, ``_stage``, ``_run_stage``, ``_run_segmented`` and
``run_device_kstream`` are its device code in torch ops over the port's
kernels.  krisp_tpu's jitted stage sweeps the duplicate rows to the tail
with a second sort and pulls a power-of-two prefix; here ``compact_rows``
keeps the unique rows (already strictly increasing) and the pull takes
exactly those.  Over several devices ``_run_sharded`` builds the table
with ``parallel.kstream_shard`` (krisp_tpu's ``_run_sharded``).

Eligibility (``device_plan`` + a content probe): one k-mer length;
plain, complements, or canonicals; N exclusion via ``--disallow Nn`` or
an ACGT-subset ``--allow``; softmask policies; DNA input whose residues
are ACGT/N (lowercase only under a softmask policy or an allow filter).
The DEVICE program itself runs the sorted single-column shapes; the
split/sort-cols/unsorted/allow shapes are host-native-core only
(``DevicePlan.host_only`` — kstream_vec.py's v2 entry).  Everything
else returns None and the caller falls back to the exact string
pipeline (krisp_tpu_torch.kstream).
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass

import numpy as np
import torch

from .budget import (ROW_LIMIT, device_budget, device_charge,
                     kstream_card_bytes, kstream_rows, kstream_tpu_bytes)
from .convert import keys_to_numpy
from .device import devices_for_run, resolve_device
from .io.fasta import bucket_size, load_buffer
from .metrics import GLOBAL as METRICS
from .ops.intersect import compact_rows, dedup_sorted
from .ops.pack import SENTINEL, window_keys_both
from .ops.sort import _BIAS, sort_words


@dataclass
class DevicePlan:
    k: int
    mode: str            # "plain" | "complements" | "canonicals"
    omit_soft: bool
    map_soft: bool
    #: --allow set (uppercase ACGT subset), or None; rides the validity
    #: table on the host native core (kstream_vec.native_validity)
    allow: str | None = None
    #: --split column sizes (reference clamped front/back walk,
    #: kstream.py:805-832); None = single whole-kmer column
    split: tuple | None = None
    #: --sort-cols indices (0-based, into the OUTPUT column order)
    sortcols: tuple | None = None
    #: False = emit in window order (unsorted jobs skip the sort phase)
    sort: bool = True

    @property
    def v2(self) -> bool:
        """Shapes that need the native v2 entry (split/sortcols/unsorted);
        these run on the host native core only — no numpy mirror, no
        device program."""
        return (not self.sort) or self.split is not None

    @property
    def host_only(self) -> bool:
        """Shapes outside the device engine's coverage."""
        return self.v2 or self.allow is not None


_COMP_BASE = {"A": "T", "T": "A", "C": "G", "G": "C"}


def device_plan(kmers=None, complements=False, canonicals=False, allow=None,
                disallow=None, omitsoft=False, mapsoft=False,
                expandiupac=False, split=None, sort=False, sortcols=None):
    """Return a DevicePlan when the configuration is fast-path eligible.

    Coverage (anything else returns None and the exact string pipeline
    runs): one k-mer length; plain/complements/canonicals; N exclusion via
    ``--disallow Nn`` or an ACGT-subset ``--allow``; softmask policies;
    sorted or unsorted; ``--split`` columns with ``--sort-cols``;
    ``--expand-iupac`` (an identity on the ACGT-only content the probe
    admits — N windows are excluded by the gates above, so there is
    nothing to expand)."""
    if kmers is None:
        return None
    klist = kmers if isinstance(kmers, (list, tuple)) else [kmers]
    if len(klist) != 1 or klist[0] > 512 or klist[0] < 1:
        return None
    k = klist[0]
    # N exclusion: required so no valid window can carry an uncodeable N
    nn_disallow = disallow is not None and set(disallow) == {"N", "n"}
    if allow is not None:
        if not allow or not set(allow) <= set("ACGT"):
            return None
        if complements and any(_COMP_BASE[b] not in allow for b in allow):
            # the reference filters fwd and revcomp INDEPENDENTLY after
            # adding complements (kstream.py:203-235 order); per-window
            # validity models that only for complement-closed sets
            return None
        if not nn_disallow and disallow is not None:
            return None          # other disallow sets: string pipeline
    elif not nn_disallow:
        return None
    mode = ("canonicals" if canonicals
            else "complements" if complements else "plain")
    split_t = None
    if split is not None:
        split_t = (split,) if isinstance(split, int) else tuple(split)
    sortcols_t = None
    if sort and sortcols and split_t is not None:
        if any(c < 0 for c in sortcols):
            return None          # negative indices: string-pipeline quirk
        sortcols_t = tuple(sortcols)
    if (split_t is not None or not sort) and k > 64:
        return None              # v2 shapes live in the <=64 native core
    return DevicePlan(k=k, mode=mode, omit_soft=omitsoft,
                      map_soft=mapsoft, allow=allow, split=split_t,
                      sortcols=sortcols_t, sort=bool(sort))


def content_ok(buf, plan: DevicePlan) -> bool:
    """Content probe shared by the device and host-vectorized engines:
    they cover ACGT/N input (case per softmask policy — or under --allow,
    where lowercase windows are dropped by validity); anything else (IUPAC
    residues, RNA, lowercase that would pass through unchanged) falls back
    to the exact string pipeline."""
    present = np.zeros(256, bool)
    present[buf] = True
    allowed = np.zeros(256, bool)
    for b in "ACGTN":
        allowed[ord(b)] = True
    allowed[0] = True
    if plan.omit_soft or plan.map_soft or plan.allow is not None:
        for b in "acgtn":
            allowed[ord(b)] = True
    return not present[~allowed].any()


def run_device_kstream(path, plan: DevicePlan, out_stream, device="cuda"):
    """Execute the plan on ``device``; writes sorted k-mer lines to
    ``out_stream`` (binary).  Returns line count, or None when the plan
    is host-only or the input content forces a fallback to the host
    pipeline (IUPAC residues, RNA, lowercase without a softmask policy).
    ``kstream_route`` picks the path from sizes alone, against
    ``budget.device_budget``: over several devices, where one device's
    share of the job fits, the job is sharded (``_run_sharded``); other
    jobs that do not fit take the segmented path.  A device out-of-memory
    error raises on every path (krisp_tpu hands the job to its
    single-device paths or the string pipeline instead, which would move
    work off the cards unseen).

    ``device`` "cuda" (the default) launches the kernels and raises
    without a card; "cpu" runs their plain versions."""
    if plan.host_only:
        return None          # split/sortcols/unsorted/allow: host engine
    dev = resolve_device(device)
    k = plan.k
    with METRICS.stage("read_fasta"):
        buf = load_buffer(path)
    if not content_ok(buf, plan):
        return None
    if buf.size < k:
        return 0             # no window: nothing to launch

    padded = np.zeros(bucket_size(buf.size), np.uint8)
    padded[:buf.size] = buf

    budget = device_budget(dev)
    n_dev = devices_for_run(None, dev)
    route = kstream_route(padded.size, k, plan.mode, budget, n_dev, dev)
    if route == "sharded":
        from .parallel import distributed
        n = _run_sharded(buf, plan, out_stream, distributed.make_mesh(n_dev))
        if n is not None:
            return n
        route = kstream_route(padded.size, k, plan.mode, budget, 1, dev)
    if route == "segmented":
        return _run_segmented(buf, plan, out_stream, budget, dev)

    words_h, reps, n_unique = _run_stage(padded, plan, dev)

    with METRICS.stage("decode", items=n_unique):
        chars = _decode_chars(words_h, n_unique, k, newline=True)
    with METRICS.stage("expand+write", items=int(reps.sum())):
        if (reps == 1).all():
            out_stream.write(chars.tobytes())
        else:
            out_stream.write(np.repeat(chars, reps, axis=0).tobytes())
    if os.environ.get("KRISP_TPU_TIMING"):
        print("kstream-device: " + ", ".join(
            f"{name} {s.seconds:.3f}s" for name, s in METRICS.stages.items()),
            file=sys.stderr)
    return int(reps.sum())


def kstream_route(n_padded: int, k: int, mode: str, budget: int,
                  n_dev: int = 1, dev="cuda") -> str:
    """The device engine's path for ``n_padded`` window starts at k-mer
    length ``k`` in ``mode`` on ``dev``: "sharded" over ``n_dev`` > 1
    devices where a device's share of the charge fits ``budget``,
    "segmented" where the one-shot stage's charge does not fit, else
    "one_shot".  The charge (``budget.device_charge``) is, on a card,
    ``budget.kstream_card_bytes`` a window start (the stage holds the
    whole window table: key words and counts through the sort and the
    duplicate collapse) and the sort's rows, which must stay under
    ``budget.ROW_LIMIT`` (all shards together, since one owner may receive
    every row); on the CPU krisp_tpu's estimate alone."""
    rows, est = device_charge(dev, kstream_rows(n_padded, mode),
                              n_padded * kstream_card_bytes(k, mode),
                              n_padded * kstream_tpu_bytes(k))
    rows_ok = rows < ROW_LIMIT
    if n_dev > 1 and est // n_dev <= budget and rows_ok:
        return "sharded"
    if est > budget or not rows_ok:
        return "segmented"
    return "one_shot"


def segment_starts(budget: int, k: int, mode: str, dev="cuda") -> int:
    """Window starts a segment of ``_run_segmented`` owns: as many as
    ``budget`` bytes are charged for on ``dev`` (``kstream_route``'s
    charge of one window start), at least max(k, 4096), and few enough
    that a segment's rows, its bucket's rounding included, stay under the
    kernels' ``budget.ROW_LIMIT``."""
    _, per_start = device_charge(dev, 0, kstream_card_bytes(k, mode),
                                 kstream_tpu_bytes(k))
    S = max(int(budget) // per_start, max(k, 4096))
    return min(S, (ROW_LIMIT - 1) // kstream_rows(1, mode) - (k - 1)
               - (1 << 16))


def _embed_params(k, bits):
    """(spare bits in the last key word, whether counts embed there)."""
    n_words = (bits * k + 31) // 32
    spare = 32 * n_words - bits * k
    return spare, spare >= 2


def mode_keys(ok, fwd, rc, mode, start_limit=None):
    """fwd/rc selection per mode + sentinel masking (krisp_tpu's
    ``mode_keys``, over the window-key kernel's outputs).

    ``ok`` bool[n_win], ``fwd``/``rc`` int32[W, n_win] (u32 bit patterns)
    as ``window_keys_both`` returns them.  ``start_limit`` masks windows
    whose START index is past it (segment overlap tails give context
    only).  Returns (keys int32[W, m] with invalid rows all ones, validity
    bool[m]): m = 2 n_win for complements (forward rows, then reverse
    complements), n_win otherwise.  The canonical minimum compares words
    biased by 2**31, whose signed order is the words' unsigned order."""
    okw = ok
    if start_limit is not None:
        okw = ok.clone()
        okw[start_limit:] = False
    if mode == "plain":
        return torch.where(okw, fwd, SENTINEL), okw
    if mode == "complements":
        use, okk = torch.cat([fwd, rc], dim=1), torch.cat([okw, okw])
    else:  # canonicals: lexicographic min of fwd/rc keys
        n_win = okw.shape[0]
        less = torch.zeros(n_win, dtype=torch.bool, device=ok.device)
        decided = torch.zeros_like(less)
        for a, b in zip(fwd, rc):
            ne = a != b
            less = torch.where(~decided & ne, (a ^ _BIAS) < (b ^ _BIAS), less)
            decided |= ne
        use, okk = torch.where(less | ~decided, fwd, rc), okw
    return use.masked_fill_(~okk, SENTINEL), okk


def _stage(buffer, k, mode, omit_soft, start_limit=None):
    """The device stage on one uint8[P] buffer: windows -> mode keys ->
    sort -> dedup -> compaction, counts embedded in the spare key bits
    when possible.

    ``start_limit``: only windows STARTING at buffer index < start_limit
    are counted — the segmented path gives each segment an overlap tail of
    k-1 bases for context while the tail's window starts belong to the
    next segment.

    Count embedding: valid keys occupy the top 2k bits of the word row, so
    the last word keeps ``spare`` zero low bits.  Small multiplicities ride
    there for free, shrinking the device->host pull from W+1 to W words
    per unique k-mer.  The all-ones value is an overflow marker: those
    rows' exact counts come from a second (rare) pull of the count row.

    Returns (packed int32[W or W+1, n_unique], counts int32[n_unique],
    n_unique, n_over)."""
    dev = buffer.device
    with METRICS.stage("window_keys+mode_keys", items=buffer.numel(),
                       device=dev):
        ok, fwd, rc = window_keys_both(buffer, k, 0, 0, 2, 1, omit_soft)
        use, okk = mode_keys(ok, fwd, rc, mode, start_limit)
        del ok, fwd, rc
        n_valid = int(okk.sum())
        del okk
    with METRICS.stage("sort", items=use.shape[1], device=dev):
        keys = sort_words(use)
        del use
    with METRICS.stage("dedup+compact", items=n_valid, device=dev):
        words, cnt = dedup_sorted(keys, n_valid)
        del keys
        # the heads are strictly increasing already: keeping them in order
        # gives the prefix krisp_tpu's second sort sweeps them into
        (words, cnt), n_unique = compact_rows([words, cnt], cnt > 0)
        spare, embed = _embed_params(k, 2)
        if embed:
            emb_max = (1 << spare) - 1
            words[-1] |= torch.clamp(cnt, max=emb_max)
            n_over = int((cnt >= emb_max).sum())
            packed = words
        else:
            packed = torch.cat([words, cnt[None]])
            n_over = 0
    return packed, cnt, n_unique, n_over


def _run_stage(padded, plan: DevicePlan, dev, start_limit=None):
    """Upload one padded buffer, run the stage and pull its unique rows.
    Returns (words_h uint32[W, n_unique], reps int64[n_unique],
    n_unique)."""
    k = plan.k
    spare, embed = _embed_params(k, 2)
    with METRICS.stage("upload", items=padded.size, device=dev):
        buffer = torch.from_numpy(padded).to(dev)
    packed, cnt_d, n_unique, n_over = _stage(buffer, k, plan.mode,
                                             plan.omit_soft, start_limit)
    del buffer
    with METRICS.stage("pull", items=n_unique):
        sub = keys_to_numpy(packed)
        del packed
        if embed:
            words_h = sub
            mask = np.uint32((1 << spare) - 1)
            reps = (sub[-1] & mask).astype(np.int64)
            if n_over:
                # rare: some count saturated the spare bits; pull exact counts
                exact = cnt_d.cpu().numpy().astype(np.int64)
                reps = np.where(reps == int(mask), exact, reps)
        else:
            words_h = sub[:-1]
            reps = sub[-1].astype(np.int64)
    return words_h, reps, n_unique


#: rows decoded at a time (bounds the 8-base gather table of a slab)
_DECODE_ROWS = 1 << 16


def _decode_chars(words_h, n_unique, k, newline):
    """Vectorized text decode of the unique key table (uint32[W, n], the
    2-bit KeyLayout(k, 0, 0, 2, 1) rows: base i at bit 2i from the top of
    the row, so the top and bottom 16 bits of word w hold bases 16w..16w+7
    and 16w+8..16w+15).

    krisp_tpu decodes one base column at a time; that took 16.4 of a
    20.1 s run at k = 28 and 203 of 231 s at k = 100 on 40 Mb on the H100
    host.  Here each 16-bit half-word goes through the host engine's
    table of 8 ASCII bases (``kstream_vec._LUT16``), slab by slab: the
    same bytes with 8 times fewer gathers; the chars past k (the genome-id
    field, embedded counts) are dropped."""
    from .kstream_vec import _LUT16

    chars = np.empty((n_unique, k + (1 if newline else 0)), np.uint8)
    n8 = (k + 7) // 8
    for lo in range(0, n_unique, _DECODE_ROWS):
        hi = min(lo + _DECODE_ROWS, n_unique)
        block = np.empty((hi - lo, n8), np.uint64)
        for j in range(n8):
            word = words_h[j // 2][lo:hi]
            half = word >> np.uint32(16) if j % 2 == 0 else word & np.uint32(
                0xFFFF)
            block[:, j] = _LUT16[half]
        chars[lo:hi, :k] = block.view(np.uint8)[:, :k]
    if newline:
        chars[:, k] = ord("\n")
    return chars


def _run_sharded(buf, plan: DevicePlan, out_stream, mesh):
    """The job over ``mesh`` (krisp_tpu's ``_run_sharded``): the sorted
    unique table of ``parallel.kstream_shard``, decoded and written in
    shard (= key) order, byte-identical to the one-shot path.  Returns the
    line count, or None when the input is too short to shard (the caller
    takes its single-device path)."""
    from .parallel.kstream_shard import sharded_kstream_table

    k = plan.k
    with METRICS.stage("sharded_table", items=int(buf.size)):
        sharded = sharded_kstream_table(mesh, buf, k, plan.mode,
                                        plan.omit_soft)
    if sharded is None:
        return None
    words, cnts = sharded
    n_unique = words.shape[1]
    with METRICS.stage("decode", items=n_unique):
        chars = _decode_chars(words, n_unique, k, newline=True)
    with METRICS.stage("expand+write", items=int(cnts.sum())):
        if n_unique and (cnts == 1).all():
            out_stream.write(chars.tobytes())
        elif n_unique:
            out_stream.write(np.repeat(chars, cnts, axis=0).tobytes())
    return int(cnts.sum())


def _run_segmented(buf, plan: DevicePlan, out_stream, budget, device="cuda"):
    """Inputs the one-shot stage does not fit (``kstream_route``):
    fixed-size segments (``segment_starts``: as many window starts as
    ``budget`` bytes are charged for, fewer rows than the kernels take;
    k-1 overlap for window context) each sorted/deduped on ``device``,
    unique (k-mer, count) runs spilled to disk, then one host merge summing
    counts of k-mers that recur across segments.  Byte-identical to the
    one-shot path."""
    import heapq
    import itertools
    import tempfile

    dev = resolve_device(device)
    k = plan.k
    S = segment_starts(budget, k, plan.mode, dev)
    if buf.size <= S:                    # only one segment: not actually
        S = buf.size                     # over budget; still correct
    P = bucket_size(S + k - 1)

    runs = []
    with tempfile.TemporaryDirectory(prefix="kstream_seg_") as td:
        for si, off in enumerate(range(0, int(buf.size), S)):
            seg = buf[off:off + S + k - 1]
            padded = np.zeros(P, np.uint8)
            padded[:seg.size] = seg
            words_h, reps, n_unique = _run_stage(padded, plan, dev,
                                                 start_limit=S)
            if n_unique == 0:
                continue
            chars = _decode_chars(words_h, n_unique, k, newline=False)
            txt = f"{td}/run{si}.kmers"
            cnt = f"{td}/run{si}.npy"
            with open(txt, "wb") as fh:
                fh.write(chars.tobytes())
            np.save(cnt, reps)
            runs.append((txt, cnt))

        def run_iter(txt_path, cnt_path):
            counts = np.load(cnt_path)
            with open(txt_path, "rb") as fh:
                i = 0
                while True:
                    block = fh.read(k * 65536)
                    if not block:
                        break
                    for j in range(0, len(block), k):
                        yield block[j:j + k], int(counts[i])
                        i += 1

        total = 0
        merged = heapq.merge(*(run_iter(t, c) for t, c in runs),
                             key=lambda t: t[0])
        for kmer, grp in itertools.groupby(merged, key=lambda t: t[0]):
            n = sum(c for _, c in grp)
            total += n
            line = kmer + b"\n"
            while n > 0:                 # bounded expansion buffers
                m = min(n, 65536)
                out_stream.write(line * m)
                n -= m
    return total
