"""The four-card spacer cell (``spacer-5x240Mb-4card.distant``): its
configuration against the one-card spacer search it scales up, the route
its sizes take in the program, its metrics in the manifest, the readers of
the sharded route's stages on a synthetic record and trace, and a stage
that waits for every card it is given."""

import pytest
import torch

from benchmark import harness, problem
from benchmark.trace import Trace
from benchmark.tests import tiny

CELL = "spacer-5x240Mb-4card.distant"
NAME = "spacer-5x240Mb-4card"
NEW = ("exchange_s", "merge_words.roofline_pct", "owner_s")
M = tiny.manifest()


def test_config_is_the_spacer_search_at_240_mb():
    four, one = tiny.config(NAME, 240_000_000), tiny.config("spacer-5x40Mb")
    assert set(four) == set(one)
    for key in ("entry", "window", "flags", "guarantees", "control",
                "genomes", "ingroup", "reduced"):
        assert four[key] == one[key], key
    assert four["genome_bases"] == 240_000_000
    assert "Haas et al. 2009" in four["source"]
    assert "T30-4" in four["assumed"]["genome_bases"]


def test_cell_takes_four_cards_over_distant_genomes():
    cell, config, traffic = harness.cell_inputs(M, CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        NAME, "distant", 4)
    assert config["genome_bases"] == 240_000_000
    assert traffic == tiny.traffic("distant")


def test_a_search_weighs_2_4_g_windows():
    """16 records of 15 Mb a genome (``genomes.SHAPE``), both strands."""
    c = tiny.config(NAME, 240_000_000)
    L = sum(c["window"].values())
    contigs = [[15_000_000] * 16] * c["genomes"]
    assert problem.kmers(contigs, L) == 2_399_995_680
    assert problem.key_words(L, 2, c["genomes"]) == 2


def test_the_sizes_need_the_sharded_route():
    """One card's table would reach the kernels' 2**31 rows; over four
    cards each shard's table holds 600,002,560 rows, and each card's
    charge (about 23.5 GiB) is for its own shard."""
    from krisp_tpu_torch import budget
    from krisp_tpu_torch.engine import pipeline as TP
    from krisp_tpu_torch.ops.encode import KeyLayout
    from krisp_tpu_torch.parallel.distributed import Mesh
    c = tiny.config(NAME, 240_000_000)
    w = c["window"]
    L = w["left"] + w["mid"] + w["right"]
    layout = KeyLayout(w["left"], w["mid"], w["right"], 2, c["genomes"])
    sizes = [c["genome_bases"] + 1] * c["genomes"]   # a buffer's NUL
    assert TP.fused_charge(sizes, layout, L)[0] >= budget.ROW_LIMIT
    rows, card = TP.fused_charge(sizes, layout, L, 4)
    assert rows == 5 * 2 * 60_000_256 == 600_002_560
    assert 23 * 2**30 < card < 24 * 2**30
    cards = [torch.device("cuda", i) for i in range(4)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KRISP_TPU_HBM_BUDGET", str(card))
        assert TP.takes_fused(sizes, layout, L, cards[0], Mesh(cards))
        assert not TP.takes_fused(sizes, layout, L, cards[0])


def test_the_cell_reports_what_spacer_distant_reports():
    """Every metric of the one-card spacer cell, and the three of the
    sharded route, which no other cell reports."""
    def names(cell, kind):
        return {m["name"] for m in harness.cell_metrics(M, cell, kind)}
    for kind in ("end_to_end", "per_layer"):
        assert names("spacer-5x40Mb.distant", kind) <= names(CELL, kind)
    assert names(CELL, "per_layer") - names("spacer-5x40Mb.distant",
                                            "per_layer") == set(NEW)
    for m in M["per_layer"]:
        if m["name"] in NEW:
            assert m["workloads"] == [CELL] and m["moves"] == "kmers_per_s"


def _record():
    run = harness.Run(setup_s=30.0, problem={
        "kmers": 1000, "bases": 600, "key_words": 2})
    run.stages = {"owner": {"seconds": 0.75, "calls": 3, "items": 3000},
                  "exchange": {"seconds": 1.5, "calls": 3, "items": 2200},
                  "merge": {"seconds": 0.6, "calls": 3, "items": 2_000_000}}
    run.searches = [{"wall_s": 9.0, "work": 1000, "stages": {}}] * 3
    return run


def test_stage_readers_of_the_sharded_route():
    run = _record()
    assert harness.load_reader("owner_s")(run) == pytest.approx(0.25)
    assert harness.load_reader("exchange_s")(run) == pytest.approx(0.5)
    one_card = harness.Run(setup_s=1.0)
    one_card.stages = {"sort": {"seconds": 1.0, "calls": 1, "items": 9}}
    one_card.searches = [{"wall_s": 2.0, "work": 1, "stages": {}}]
    for name in NEW:
        assert harness.load_reader(name)(one_card) is None


def test_merge_roofline_from_a_synthetic_trace():
    """Both kernels of the merge, on two cards, against the received rows
    read and written once at the key's words; a library kernel and the
    sort's do not count."""
    def k(name, card, dur):
        return {"ph": "X", "name": name, "cat": "kernel", "ts": 10.0,
                "dur": dur, "args": {"device": card}}
    events = [{"ph": "X", "name": "bench:window", "cat": "user_annotation",
               "ts": 0.0, "dur": 1e6},
              k("(anonymous namespace)::split_kernel(unsigned int const*)",
                0, 20.0),
              k("void (anonymous namespace)::merge_kernel(unsigned int "
                "const*, long long)", 0, 180.0),
              k("(anonymous namespace)::merge_kernel(unsigned int const*)",
                1, 200.0),
              k("(anonymous namespace)::onesweep_kernel<2>()", 1, 500.0),
              k("void at::native::vectorized_elementwise_kernel<4>()", 0,
                300.0)]
    run = _record()
    run.trace = Trace(events, cards=4)
    share = harness.load_reader("merge_words.roofline_pct")(run)
    want = 100 * 2 * 2_000_000 * 8 / problem.PEAK_BYTES_PER_S / 400e-6
    assert share == pytest.approx(want)
    run.trace = Trace(events[:1], cards=4)   # no merge kernel ran
    assert harness.load_reader("merge_words.roofline_pct")(run) is None


def test_a_stage_waits_for_every_card_it_is_given(monkeypatch):
    """``Metrics.stage`` given several devices synchronises each CUDA one
    once at its end, and a single device as before."""
    from krisp_tpu_torch import metrics
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda d=None: synced.append(torch.device(d)))
    m = metrics.Metrics()
    cards = [torch.device("cuda", i) for i in range(4)]
    with m.stage("exchange", items=5, device=cards + [torch.device("cpu")]):
        assert synced == []
    assert synced == cards
    synced.clear()
    with m.stage("upload", device=torch.device("cuda", 2)):
        pass
    with m.stage("decode", device="cpu"):
        pass
    with m.stage("pull", device=("cuda:1",)):
        pass
    assert synced == [torch.device("cuda", 2), torch.device("cuda", 1)]
    assert (m.stages["exchange"].calls, m.stages["exchange"].items) == (1, 5)
