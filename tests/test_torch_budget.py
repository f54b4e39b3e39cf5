"""The port's device-memory routing (``krisp_tpu_torch/budget.py``,
``engine.pipeline``'s fused-or-staged decision, ``kstream_device``'s
one-shot-or-segmented decision) on the CPU: the budget's sources, the
charge's rows, the row guard and the absence of any fallback, on sizes
alone where the card's numbers are concerned; on the CPU the routing is
held to krisp_tpu's end to end.  Integer outputs: the tolerance is 0."""

import pytest

pytest.importorskip("jax")

import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from krisp_tpu.engine import pipeline as JP  # noqa: E402
from krisp_tpu.io.fasta import bucket_size as jax_bucket_size  # noqa: E402
from krisp_tpu.metrics import GLOBAL as JAX_METRICS  # noqa: E402
from krisp_tpu_torch import budget as B  # noqa: E402
from krisp_tpu_torch import kstream_device as KD  # noqa: E402
from krisp_tpu_torch.engine import pipeline as TP  # noqa: E402
from krisp_tpu_torch.io.fasta import bucket_size  # noqa: E402
from krisp_tpu_torch.metrics import GLOBAL as PORT_METRICS  # noqa: E402
from krisp_tpu_torch.ops.encode import KeyLayout  # noqa: E402
from krisp_tpu_torch.parallel.distributed import Mesh  # noqa: E402

SPACER = (25, 1, 2)
CUDA0 = torch.device("cuda", 0)
REPO = Path(__file__).resolve().parent.parent


def _genomes(tmp_path, sizes, seed=5, alphabet="ACGT"):
    """Random genomes of ``sizes`` bases sharing one planted window."""
    rng = np.random.default_rng(seed)
    shared = "".join(rng.choice(list("ACGT"), size=sum(SPACER)))
    paths = []
    for f, size in enumerate(sizes):
        seq = "".join(rng.choice(list(alphabet), size=size))
        seq = seq[:size // 2] + shared + seq[size // 2 + len(shared):]
        path = tmp_path / f"g{f}.fasta"
        path.write_text(f">g{f}\n{seq}\n")
        paths.append(str(path))
    return paths


def _no_card(*args, **kwargs):
    raise AssertionError("the card was queried")


def test_env_budget_wins_and_is_read_at_call_time(monkeypatch):
    """KRISP_TPU_HBM_BUDGET is the budget on every device, read at each
    call; the card is not queried when it is set."""
    monkeypatch.setattr(torch.cuda, "mem_get_info", _no_card)
    monkeypatch.setenv("KRISP_TPU_HBM_BUDGET", "12345")
    assert B.device_budget("cpu") == 12345
    assert B.device_budget(CUDA0) == 12345
    monkeypatch.setenv("KRISP_TPU_HBM_BUDGET", str(1 << 40))
    assert B.device_budget("cpu") == B.device_budget(CUDA0) == 1 << 40


def test_cpu_default_is_krisp_tpus(monkeypatch):
    monkeypatch.delenv("KRISP_TPU_HBM_BUDGET", raising=False)
    monkeypatch.setattr(torch.cuda, "mem_get_info", _no_card)
    assert B.device_budget("cpu") == B.CPU_BUDGET == 8 << 30


@pytest.mark.parametrize("free,cached,reserve,want", [
    (80 << 30, 0, 2 << 30, 78 << 30),
    (60 << 30, 5 << 30, 2 << 30, 63 << 30),
    (1 << 30, 0, 2 << 30, 0),
])
def test_card_default_is_free_memory_less_the_reserve(monkeypatch, free,
                                                      cached, reserve,
                                                      want):
    """Unset, a card's budget is ``budget_from`` of its free bytes plus the
    allocator's unused cache, less the reserve."""
    assert B.budget_from(free + cached, reserve) == want
    monkeypatch.delenv("KRISP_TPU_HBM_BUDGET", raising=False)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda dev: (free, 85 << 30))
    monkeypatch.setattr(torch.cuda, "memory_reserved",
                        lambda dev: cached + (3 << 30))
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda dev: 3 << 30)
    assert B.device_budget(CUDA0) == B.budget_from(free + cached)


@pytest.mark.parametrize("sizes", [
    [15_335_424] * 5,                       # 56 B a window: at 8 GiB
    [15_335_424 + 1] * 5,                   # one bucket more: past it
    [76_677_120 - 65_536, 65_536],
    [76_677_120, 1],
    [30_000_000, 1_000_000, 100_000],
])
def test_cpu_routing_is_krisp_tpus(monkeypatch, sizes):
    """On the CPU the port routes as krisp_tpu does: 56 bytes a window of
    each genome's own bucket against the 8 GiB default."""
    monkeypatch.delenv("KRISP_TPU_HBM_BUDGET", raising=False)
    layout = KeyLayout(*SPACER, 2, len(sizes))
    want = 56 * 2 * sum(jax_bucket_size(s) for s in sizes) <= 8 << 30
    got = TP.takes_fused(sizes, layout, sum(SPACER), torch.device("cpu"))
    assert got == want


@pytest.mark.parametrize("offset,fused", [(0, True), (-1, False)])
def test_cpu_routing_matches_krisp_tpu_end_to_end(tmp_path, monkeypatch,
                                                  offset, fused):
    """At krisp_tpu's cut (a budget of exactly its estimate, and one byte
    less) both packages take the same route and write the same groups."""
    sizes = [3000, 2000, 5000]
    paths = _genomes(tmp_path, sizes)
    est = 56 * 2 * sum(jax_bucket_size(s) for s in sizes)
    tmp = tmp_path / "tmp"
    tmp.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(tmp))
    monkeypatch.setenv("KRISP_TPU_HBM_BUDGET", str(est + offset))
    JAX_METRICS.reset()
    PORT_METRICS.reset()
    want = JP.run_pipeline(paths[:2], paths[2:], JP.KmerGeometry(*SPACER),
                           ingroup_filter=False)
    got = TP.run_pipeline(paths[:2], paths[2:], TP.KmerGeometry(*SPACER),
                          ingroup_filter=False, device="cpu")
    assert ("intersect" in JAX_METRICS.stages) == (not fused)
    assert ("intersect" in PORT_METRICS.stages) == (not fused)
    key = [(g.left, g.right, [(a.mid, a.label_counts) for a in g.amplicons])
           for g in want]
    assert [(g.left, g.right, [(a.mid, a.label_counts) for a in g.amplicons])
            for g in got] == key
    assert len(key) == 2   # the planted window, both strands


def test_charge_counts_the_largest_bucket_for_every_genome(monkeypatch):
    """Uneven genomes: the fused table holds n_files x 2 x (bucket(largest)
    - L + 1) rows, not the sum of each genome's own windows."""
    sizes = [600_000_000] + [1_000_000] * 9
    L = sum(SPACER)
    layout = KeyLayout(*SPACER, 2, len(sizes))
    rows, charge = TP.fused_charge(sizes, layout, L)
    assert rows == 10 * 2 * (bucket_size(600_000_000) - L + 1)
    assert rows > 19 * sum(2 * (bucket_size(s) - L + 1) for s in sizes) // 10
    assert charge >= rows * B.sort_row_bytes(layout.n_words)
    assert rows >= B.ROW_LIMIT
    monkeypatch.setenv("KRISP_TPU_HBM_BUDGET", str(1 << 60))
    assert not TP.takes_fused(sizes, layout, L, CUDA0)


def test_charge_rows_are_the_tables_rows(tmp_path):
    """``fused_charge``'s rows are the columns ``_fused_table`` allocates,
    for uneven genomes."""
    sizes = [70_000, 3_000, 140_000]
    paths = _genomes(tmp_path, sizes)
    geom = TP.KmerGeometry(*SPACER)
    table, layout = TP.genome_key_tables(paths, geom, device="cpu")
    rows, _ = TP.fused_charge(sizes, layout, geom.total)
    assert table.shape[1] == rows == 3 * 2 * (bucket_size(140_000) - 27)


def test_shard_charge_rows_and_shards_a_device(monkeypatch):
    """Over a mesh every shard holds n_files x 2 x chunk rows, the rows
    the charge gives; on a card the budget of each device must hold the
    shards it runs."""
    sizes = [4_000_000] * 5
    L = sum(SPACER)
    layout = KeyLayout(*SPACER, 2, 5)
    rows, shard = TP.fused_charge(sizes, layout, L, 4)
    chunk = TP._shard_chunk(sizes, L, 4)
    assert chunk == 1_000_448 and rows == 5 * 2 * chunk
    W = layout.n_words
    assert shard == B.table_bytes(
        layout, 5 * 2 * chunk, 2 * chunk,
        [B.sort_row_bytes(W), 4 * W + B.OWNER_ROW_BYTES, 3 * 4 * W,
         2 * 4 * W + B.COMPACT_ROW_BYTES])
    mesh = Mesh([CUDA0] * 4)
    for budget, want in ((4 * shard, True), (4 * shard - 1, False)):
        monkeypatch.setattr(TP, "device_budget", lambda dev: budget)
        assert TP.takes_fused(sizes, layout, L, CUDA0, mesh) == want


@pytest.mark.parametrize("geom,bits", [(SPACER, 2), ((30, 40, 30), 2),
                                       (SPACER, 4), ((5, 60, 5), 2),
                                       ((4, 1, 3), 2)])
def test_card_routing_over_budget_takes_staged(monkeypatch, geom, bits):
    """A charge one byte over the budget routes staged; at the budget,
    fused."""
    sizes = [40_000_000] * 5
    layout = KeyLayout(*geom, bits, 5)
    rows, charge = TP.fused_charge(sizes, layout, sum(geom))
    assert rows < B.ROW_LIMIT
    monkeypatch.setenv("KRISP_TPU_HBM_BUDGET", str(charge))
    assert TP.takes_fused(sizes, layout, sum(geom), CUDA0)
    monkeypatch.setenv("KRISP_TPU_HBM_BUDGET", str(charge - 1))
    assert not TP.takes_fused(sizes, layout, sum(geom), CUDA0)


def test_row_guard_sends_2_31_rows_staged(monkeypatch):
    """A table of 2**31 rows or more takes the staged path whatever the
    budget; one bucket fewer a genome stays fused."""
    L = sum(SPACER)
    layout = KeyLayout(*SPACER, 2, 5)
    over = [-(-B.ROW_LIMIT // 10) + L] * 5
    under = [over[0] - (1 << 16)] * 5
    assert TP.fused_charge(over, layout, L)[0] >= B.ROW_LIMIT
    assert TP.fused_charge(under, layout, L)[0] < B.ROW_LIMIT
    monkeypatch.setenv("KRISP_TPU_HBM_BUDGET", str(1 << 60))
    assert not TP.takes_fused(over, layout, L, CUDA0)
    assert TP.takes_fused(under, layout, L, CUDA0)
    # over a mesh the guard counts each shard's own rows, a quarter of
    # them here; an owner that would receive more raises in the exchange
    assert TP.fused_charge(over, layout, L, 4)[0] < B.ROW_LIMIT
    assert TP.takes_fused(over, layout, L, CUDA0, Mesh([CUDA0] * 4))
    # the card's charge holds the rows; the CPU's (krisp_tpu's) counts none
    assert B.device_charge(CUDA0, B.ROW_LIMIT, 5, 7) == (B.ROW_LIMIT, 5)
    assert B.device_charge("cpu", B.ROW_LIMIT, 5, 7) == (0, 7)


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("reaches", [True, False])
def test_row_guard_counts_one_shards_rows(monkeypatch, n_shards, reaches):
    """Over a mesh a shard whose own table reaches 2**31 rows takes the
    staged path whatever the budget, on distinct cards and on one card
    running every shard; a chunk of 1024 bases fewer stays fused."""
    L = sum(SPACER)
    layout = KeyLayout(*SPACER, 2, 5)
    # 5 genomes x 2 strands x chunk rows a shard, chunks of 1024 bases
    chunk = (-(-B.ROW_LIMIT // 10 // 1024) - (0 if reaches else 1)) * 1024
    sizes = [n_shards * chunk] * 5
    rows, _ = TP.fused_charge(sizes, layout, L, n_shards)
    assert rows == 10 * chunk and (rows >= B.ROW_LIMIT) == reaches
    monkeypatch.setenv("KRISP_TPU_HBM_BUDGET", str(1 << 60))
    for devices in ([CUDA0] * n_shards,
                    [torch.device("cuda", i) for i in range(n_shards)]):
        assert TP.takes_fused(sizes, layout, L, CUDA0,
                              Mesh(devices)) != reaches


@pytest.mark.parametrize("mode,n", [("complements", 1 << 30),
                                    ("plain", 1 << 31),
                                    ("canonicals", 1 << 31)])
def test_row_guard_sends_kstream_one_shot_to_segments(mode, n):
    """On a card a one-shot sort of 2**31 rows or more is segmented (never
    sharded) whatever the budget; a bucket fewer runs one shot; on the CPU
    the rule is krisp_tpu's budget alone."""
    huge = 1 << 60
    assert B.kstream_rows(n, mode) == B.ROW_LIMIT
    assert KD.kstream_route(n, 28, mode, huge) == "segmented"
    assert KD.kstream_route(n, 28, mode, huge, n_dev=4) == "segmented"
    assert KD.kstream_route(n - (1 << 16), 28, mode, huge) == "one_shot"
    assert KD.kstream_route(n - (1 << 16), 28, mode, huge,
                            n_dev=4) == "sharded"
    assert KD.kstream_route(n, 28, mode, huge, dev="cpu") == "one_shot"


@pytest.mark.parametrize("k", [12, 28, 100, 512])
@pytest.mark.parametrize("mode", ["plain", "complements", "canonicals"])
def test_kstream_segments_stay_under_the_row_limit(k, mode):
    """A segment of the segmented path, its bucket included, stays under
    the kernels' row limit at any budget; under krisp_tpu's budgets the
    CPU's segments are krisp_tpu's."""
    for dev in (CUDA0, "cpu"):
        S = KD.segment_starts(1 << 60, k, mode, dev)
        assert B.kstream_rows(bucket_size(S + k - 1), mode) < B.ROW_LIMIT
    assert KD.segment_starts(36_000_000, k, mode, "cpu") == max(
        36_000_000 // (2 * ((2 * k + 31) // 32 + 1) * 12), 4096, k)


@pytest.mark.parametrize("k,mode,over", [(12, "complements", True),
                                         (28, "complements", True),
                                         (33, "complements", False),
                                         (28, "canonicals", False),
                                         (100, "complements", False)])
def test_kstream_charge_covers_the_duplicate_collapse(k, mode, over):
    """On a card the charge is krisp_tpu's estimate, raised where the
    duplicate collapse of every window's rows needs more (complements at
    k <= 32); on the CPU it is krisp_tpu's."""
    W = (2 * k + 31) // 32
    krisp = 2 * (W + 1) * 4 * 3
    assert B.kstream_tpu_bytes(k) == krisp
    card = B.kstream_card_bytes(k, mode)
    assert card >= B.kstream_rows(1, mode) * (4 * W + B.DEDUP_ROW_BYTES)
    assert (card > krisp) == over


def test_device_error_in_the_fused_path_raises(tmp_path, monkeypatch):
    """A device error raised while the fused table is built reaches the
    caller: nothing retries the staged path or makes a table directory."""
    paths = _genomes(tmp_path, [3000, 3000, 3000])

    def boom(*args, **kwargs):
        raise torch.OutOfMemoryError("CUDA out of memory (forced)")
    made = []
    monkeypatch.setattr(TP, "_fused_table", boom)
    monkeypatch.setattr(tempfile, "mkdtemp",
                        lambda *a, **k: made.append(a) or str(tmp_path))
    PORT_METRICS.reset()
    with pytest.raises(torch.OutOfMemoryError):
        TP.run_pipeline(paths[:2], paths[2:], TP.KmerGeometry(*SPACER),
                        device="cpu")
    assert made == []
    assert not {"extract+sort", "intersect"} & set(PORT_METRICS.stages)


def test_device_error_in_the_kstream_stage_raises(tmp_path, monkeypatch):
    """A device error in the one-shot stage reaches the caller: the
    segmented path is not tried."""
    path = tmp_path / "k.fasta"
    path.write_text(">k\n" + "ACGTTGCA" * 500 + "\n")
    plan = KD.device_plan(kmers=28, canonicals=True, disallow="Nn",
                          sort=True)

    def boom(*args, **kwargs):
        raise torch.OutOfMemoryError("CUDA out of memory (forced)")
    segmented = []
    monkeypatch.setattr(KD, "_run_stage", boom)
    monkeypatch.setattr(KD, "_run_segmented",
                        lambda *a, **k: segmented.append(a))
    with pytest.raises(torch.OutOfMemoryError):
        KD.run_device_kstream(str(path), plan, open(tmp_path / "o", "wb"),
                              device="cpu")
    assert segmented == []


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("budgets,route", [
    ((1 << 40, 0), "staged"),       # one rank's device does not fit
    ((0, 1 << 40), "staged"),
    ((1 << 40, 1 << 40), "fused"),  # every rank's does: the sharded path
])
def test_process_group_takes_one_route(tmp_path, budgets, route):
    """Over a process group (``multihost.pod_mesh``) whose ranks see
    different budgets, every rank takes the route that all of them fit
    (``Mesh.all_true``): none waits in a collective of the sharded path
    that another rank never calls.  Two gloo processes over the CPU
    (``tests/torch_budget_worker.py``), each with its own budget; both
    write the groups of one device's run."""
    paths = _genomes(tmp_path, [3000, 2000, 5000])
    want = TP.run_pipeline(paths[:2], paths[2:], TP.KmerGeometry(*SPACER),
                           ingroup_filter=False, device="cpu")
    want = repr([(g.left, g.right, [(a.mid, a.label_counts)
                                    for a in g.amplicons]) for g in want])
    port = _free_port()
    worker = Path(__file__).parent / "torch_budget_worker.py"
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(port), str(rank), "2",
         str(budgets[rank]), *paths],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO)
        for rank in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=180)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (rc, out, err) in enumerate(outs):
        assert rc == 0, err[-3000:]
        lines = dict(line.split(" ", 1) for line in out.splitlines()
                     if line.startswith(("ROUTE", "GROUPS")))
        assert lines["ROUTE"] == f"{rank} {route}"
        assert lines["GROUPS"] == want
