"""Device-memory routing of the port: the budget a run may fill on its
device, the bytes the fused search and the kstream one-shot stage charge
against it, and the row limit of the kernels.

``device_budget`` reads ``KRISP_TPU_HBM_BUDGET`` at call time, as
krisp_tpu does; unset, a card's budget is its free memory at call time
less ``CARD_RESERVE`` (``budget_from``), and the CPU's is krisp_tpu's
default of 8 GiB.  ``device_charge`` is the one place where the card's
rule and the CPU's part: on a card a stage is charged its rows, held to
``ROW_LIMIT``, and the port's own bytes; on the CPU krisp_tpu's estimate
and no rows, so that CPU runs route as krisp_tpu's do.

The card's charges describe the port's own tables, in bytes a row (the
callers count the rows and list their steps' bytes a row): the buffers the
code holds at each step, with the constants the steps' temporaries need
as measured by ``chip_smoke.py`` phase 14 on an H100 (``PERF.md`` §3).
Every step's charge is the worst case over the data: every row a
survivor of the scan (related genomes, or one genome), one prefix group a
row for the prefilter, one unique row a row for kstream's duplicate
collapse.

No route is chosen by trying one: an input the charge or the row limit
sends to the staged or segmented path goes there before anything is
allocated, and a device out-of-memory error raises.
"""

from __future__ import annotations

import os

import torch

from .ops.sort import KEY_MODE_WORDS

#: krisp_tpu's ``KRISP_TPU_HBM_BUDGET`` default, sized for a TPU v5e; the
#: port's budget on the CPU
CPU_BUDGET = 8 << 30
#: krisp_tpu's charge for the fused search: bytes a window of each
#: genome's own bucket, both strands (the port's rule on the CPU)
KRISP_TPU_WINDOW_BYTES = 56
#: bytes of a card's free memory left out of its budget: the CUDA modules
#: loaded at first use and the allocator's rounding and split blocks when
#: memory runs short (``chip_smoke.py`` phase 14 runs the searches whose
#: peaks come nearest their charges with only the charge and this much
#: free; PERF.md §3)
CARD_RESERVE = 1 << 30
#: the sort, merge and scan kernels take fewer rows than this (32-bit row
#: ids); a fused table or a one-shot kstream sort of this many rows or
#: more takes the staged or segmented path
ROW_LIMIT = 1 << 31

#: bytes a row, beside the table's key words, that the prefilter's
#: temporaries reach when every row heads its own prefix group
#: (``ops.intersect.prefilter_rows``)
PREFILTER_ROW_BYTES = 56
#: bytes a row, beside the key words twice, of the compaction after the
#: scan when every row survives (``ops.intersect.global_stage``): the
#: scan's keep, counts and gid (9), the kept row ids (8), the kept counts
#: and gids (8)
COMPACT_ROW_BYTES = 25
#: bytes a row of one genome's table that its extraction holds beside the
#: table: the unpacked bytes and their temporaries on the 2-bit route; on
#: the 4-bit route this plus the key words twice (``window_keys_bits``'
#: strands and their stack), which is ``extract_row_bytes``
EXTRACT_ROW_BYTES = 16
#: bytes a row of a shard's table that the owner computation holds beside
#: the sorted keys (``parallel.distributed._owner_of``)
OWNER_ROW_BYTES = 26
#: bytes a row of kstream's one-shot stage, beside the sorted keys, that
#: the duplicate collapse holds (``ops.intersect.dedup_sorted``: counts,
#: head flags, run heads and their successors) when every row is unique
DEDUP_ROW_BYTES = 34
#: bytes a row, beside the key words twice, of kstream's compaction of
#: the unique rows (``kstream_device._stage``): counts, the mask, the
#: kept row ids and the kept counts
KSTREAM_COMPACT_ROW_BYTES = 17
#: bytes a row for the small buffers of every step: the sort's status
#: words (a quarter of a byte a row), histograms, the per-genome upload
ROW_SLACK = 1


def budget_from(free: int, reserve: int = CARD_RESERVE) -> int:
    """A card's budget from its free bytes: ``free`` less ``reserve``,
    never below 0."""
    return max(int(free) - int(reserve), 0)


def device_budget(dev) -> int:
    """The bytes a run on ``dev`` may fill: ``KRISP_TPU_HBM_BUDGET`` when
    set (read now); else for a card its free memory now (the driver's free
    bytes plus the blocks PyTorch's allocator holds unused, which it hands
    back before it would fail) less ``CARD_RESERVE``; else (the CPU)
    ``CPU_BUDGET``."""
    env = os.environ.get("KRISP_TPU_HBM_BUDGET")
    if env is not None:
        return int(env)
    dev = torch.device(dev)
    if dev.type != "cuda":
        return CPU_BUDGET
    free, _total = torch.cuda.mem_get_info(dev)
    cached = torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(
        dev)
    return budget_from(free + cached)


def device_charge(dev, rows: int, card_bytes: int,
                  cpu_bytes: int) -> tuple[int, int]:
    """(rows, bytes) that a stage is charged on ``dev`` against
    ``device_budget(dev)``: on a card its ``rows``, which must stay under
    ``ROW_LIMIT``, and ``card_bytes``, the port's own charge; elsewhere no
    rows and ``cpu_bytes``, krisp_tpu's estimate, so that CPU runs route as
    krisp_tpu's do."""
    if torch.device(dev).type == "cuda":
        return rows, card_bytes
    return 0, cpu_bytes


def sort_row_bytes(n_words: int) -> int:
    """Bytes a row of ``ops.sort.sort_words`` at ``n_words`` words: the
    input, the output and the scratch (the key words in key mode, six
    words in index mode)."""
    if n_words <= KEY_MODE_WORDS:
        return 3 * 4 * n_words
    return 2 * 4 * n_words + 24


def extract_row_bytes(bits: int, n_words: int) -> int:
    """Bytes a row of one genome's table that its extraction holds beside
    the whole table."""
    return EXTRACT_ROW_BYTES + (2 * 4 * n_words if bits != 2 else 0)


def table_bytes(layout, rows: int, genome_rows: int, stages) -> int:
    """The peak on one device of a search over a table of ``rows`` rows
    (``genome_rows`` a genome): the larger of the extraction (the table
    and one genome's temporaries) and the steps after it, whose bytes a
    row ``stages`` lists (the fused path's or a shard's)."""
    W = layout.n_words
    extract = (4 * W * rows
               + extract_row_bytes(layout.bits, W) * genome_rows)
    return max(max(stages) * rows, extract) + ROW_SLACK * rows


def kstream_rows(n_bases: int, mode: str) -> int:
    """Rows of the kstream one-shot sort over ``n_bases`` window starts:
    both strands' rows with ``complements``, one a window otherwise."""
    return n_bases * (2 if mode == "complements" else 1)


def kstream_tpu_bytes(k: int) -> int:
    """krisp_tpu's estimate of the bytes a window start of kstream's device
    stage: both strands' rows of key words and a count, three buffers
    through the sort."""
    return 2 * ((2 * k + 31) // 32 + 1) * 4 * 3


def kstream_card_bytes(k: int, mode: str) -> int:
    """The bytes a window start that kstream's device stage is charged on
    a card: krisp_tpu's estimate, raised to the duplicate collapse's and
    the compaction's peaks where they need more (``complements`` at
    k <= 32)."""
    W = (2 * k + 31) // 32
    collapse = max(4 * W + DEDUP_ROW_BYTES,
                   2 * 4 * W + KSTREAM_COMPACT_ROW_BYTES)
    return max(kstream_tpu_bytes(k),
               kstream_rows(1, mode) * (collapse + ROW_SLACK))
