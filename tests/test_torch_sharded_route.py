"""The sharded krisp_fasta route as ``run_pipeline`` and the CLI take it
over a mesh of CPU shards (``[cpu] * n``): the per-owner row guard of the
exchange, the search's bytes against the benchmark's plain reference, and
the stages of its steps.  Integer outputs and text: the tolerance is 0."""

import contextlib

import numpy as np
import pytest
import torch

from benchmark.genomes import make_genomes
from benchmark.reference import fasta_search
from benchmark.tests import tiny
from krisp_tpu_torch import budget
from krisp_tpu_torch.cli.krisp_fasta import main as port_main
from krisp_tpu_torch.engine import pipeline as TP
from krisp_tpu_torch.metrics import GLOBAL as METRICS
from krisp_tpu_torch.parallel import distributed as TD

SPACER = TP.KmerGeometry(25, 1, 2)
#: the sharded route's stages, in the order they run
SHARDED_STAGES = ("upload", "extract", "sort", "owner", "exchange", "merge",
                  "scan", "pull")


def cpu_mesh(n):
    return TD.Mesh([torch.device("cpu")] * n)


def _fasta(tmp_path, seqs, tag):
    paths = []
    for f, seq in enumerate(seqs):
        path = tmp_path / f"{tag}{f}.fasta"
        path.write_text(f">{tag}{f}\n" + "\n".join(
            seq[i:i + 80] for i in range(0, len(seq), 80)) + "\n")
        paths.append(str(path))
    return paths


def _random_genomes(tmp_path, tag, n_files, size, alphabet="ACGT", seed=11):
    """Random genomes of ``alphabet`` sharing three planted windows, one
    of which tells the first two genomes apart from the rest."""
    rng = np.random.default_rng(seed)
    L = SPACER.total

    def bases(n, letters="ACGT"):
        return "".join(rng.choice(list(letters), size=n))
    shared = [bases(L) for _ in range(2)]
    diag = bases(L)
    seqs = []
    for f in range(n_files):
        seq = list(bases(size, alphabet))
        for i, w in enumerate(shared):
            pos = (i + 1) * size // 4
            seq[pos:pos + L] = w
        d = list(diag)
        d[SPACER.left] = "A" if f < 2 else "C"
        seq[size // 8:size // 8 + L] = d
        seqs.append("".join(seq))
    return _fasta(tmp_path, seqs, tag)


def _snapshot(groups):
    return [(g.left, g.right, [(a.mid, sorted(a.label_counts.items()))
                               for a in g.amplicons]) for g in groups]


@pytest.mark.parametrize("genome", ["a_rich", "even"])
def test_owner_guard_counts_each_owners_rows(tmp_path, monkeypatch, genome):
    """With ``budget.ROW_LIMIT`` lowered to 1.5 shard tables, every shard's
    own table stays under it while all four together exceed it.  A-rich
    genomes send about half of all rows to shard 0: the route raises
    before the exchange.  Even genomes give each owner about a shard's
    rows: the route runs the exchange and gives the single-device
    groups."""
    n, n_files, size = 4, 4, 4 * 2048
    alphabet = "AAAAAAAAAAAAAAAAAAAC" if genome == "a_rich" else "ACGT"
    paths = _random_genomes(tmp_path, genome, n_files, size, alphabet)
    shard_rows = n_files * 2 * TP._shard_chunk([size], SPACER.total, n)
    assert shard_rows == n_files * 2 * 2048
    monkeypatch.setattr(budget, "ROW_LIMIT", shard_rows * 3 // 2)
    METRICS.reset()
    if genome == "a_rich":
        with pytest.raises(RuntimeError,
                           match=r"shard 0 would receive \d+ rows.*fewer "
                                 rf"than {budget.ROW_LIMIT}"):
            TP.run_pipeline(paths[:2], paths[2:], SPACER, device="cpu",
                            mesh=cpu_mesh(n))
        assert "owner" in METRICS.stages
        assert "exchange" not in METRICS.stages
        return
    sharded = TP.run_pipeline(paths[:2], paths[2:], SPACER, device="cpu",
                              mesh=cpu_mesh(n))
    assert METRICS.stages["exchange"].calls == 1
    assert METRICS.stages["merge"].items > budget.ROW_LIMIT
    single = TP.run_pipeline(paths[:2], paths[2:], SPACER, device="cpu")
    assert single and _snapshot(sharded) == _snapshot(single)


@pytest.fixture
def mesh_cli(monkeypatch):
    """The CLI with ``--devices n`` routed onto a mesh of n CPU shards
    (``torch.cuda.device_count`` patched, the count taken as a card's,
    ``make_mesh`` patched onto the CPU); returns the shard counts the
    meshes were made for."""
    from krisp_tpu_torch import device as tdevice
    made = []
    real = tdevice.devices_for_run
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    monkeypatch.setattr(TP, "devices_for_run",
                        lambda n, dev: real(n, torch.device("cuda", 0)))
    monkeypatch.setattr(TD, "make_mesh",
                        lambda n: made.append(n) or cpu_mesh(n))
    monkeypatch.delenv("KRISP_TPU_DEVICES", raising=False)
    return made


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("mix", ["distant", "related"])
def test_sharded_search_equals_the_plain_reference(tmp_path, mesh_cli, mix,
                                                   n):
    """The benchmark's deployment (``spacer-5x240Mb-4card``: its window,
    flags and genome split) at 200 kb a genome, searched through the CLI
    with ``--devices n``: the CSV and alignment bytes equal the plain
    reference's."""
    config = tiny.config("spacer-5x240Mb-4card", bases=200_000)
    g = make_genomes(config, tiny.traffic(mix), 3_000_001_807,
                     tmp_path / "genomes")
    csv, align = tmp_path / "out.csv", tmp_path / "out.txt"
    METRICS.reset()
    assert port_main([*g.ingroup, "--outgroup", *g.outgroup,
                      *config["flags"], "--devices", str(n), "--device",
                      "cpu", "-s", str(csv), "-o", str(align)]) == 0
    assert mesh_cli == [n] and METRICS.stages["exchange"].calls == 1
    w = config["window"]
    want_csv, want_align, _ = fasta_search.search(
        g.ingroup, g.outgroup,
        fasta_search.Geometry(w["left"], w["mid"], w["right"]), "cpu")
    assert want_csv.count("\n") > 1
    assert csv.read_text() == want_csv
    assert align.read_text() == want_align


@pytest.mark.parametrize("n", [2, 4])
def test_every_sharded_step_is_one_stage(tmp_path, monkeypatch, n):
    """One sharded search over all-A genomes, whose windows' owners are
    known: forward windows (all A) belong to shard 0, reverse ones (all T)
    to the last shard.  Every step is one stage, none inside another and
    in order, with the items of its docstring: bytes uploaded with their
    halos, rows keyed, sorted and split, rows sent to another shard, rows
    received and merged, rows scanned and survivor rows pulled."""
    n_files, chunk = 3, 1024
    # a record of P bases is a buffer of P + 1 bytes, n chunks exactly
    L, P = SPACER.total, n * chunk - 1
    paths = _fasta(tmp_path, ["A" * P] * n_files, "a")
    depth, order = [0], []
    stage = METRICS.stage

    @contextlib.contextmanager
    def watched(name, *args, **kwargs):
        order.append((name, depth[0]))
        depth[0] += 1
        try:
            with stage(name, *args, **kwargs) as stat:
                yield stat
        finally:
            depth[0] -= 1
    monkeypatch.setattr(METRICS, "stage", watched)
    METRICS.reset()
    groups = TP.run_pipeline(paths[:1], paths[1:], SPACER,
                             ingroup_filter=False, device="cpu",
                             mesh=cpu_mesh(n))
    assert all(d == 0 for _, d in order)
    names = [name for name, _ in order]
    assert [s for s in names if s in SHARDED_STAGES] == list(SHARDED_STAGES)
    st = METRICS.stages
    assert all(st[s].calls == 1 for s in SHARDED_STAGES)
    rows = n * n_files * 2 * chunk
    valid = n_files * 2 * (P - L + 1)
    # forward rows leave every shard but 0, reverse ones every shard but
    # the last; the last shard's final L starts run past the genome
    moved = n_files * (2 * (n - 1) * chunk - L)
    assert {s: st[s].items for s in SHARDED_STAGES} == {
        "upload": n * n_files * (chunk + L - 1), "extract": rows,
        "sort": rows, "owner": rows, "exchange": moved, "merge": valid,
        "scan": valid, "pull": 2 * n_files}
    # one flank group a strand, held by every genome
    assert sorted(g.left + g.right for g in groups) == ["A" * 27, "T" * 27]
