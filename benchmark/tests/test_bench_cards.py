"""A cell on ``chips`` cards: the trace read one card at a time, the peak
of the fullest card, the cards a window used, the card count handed to
the program, and the run that fails where the window used another number
of cards than its cell asks for.  On one card every reading is the one the
harness gave before it counted cards: the numbers below were read from
that harness on the same record and trace."""

import importlib.util

import pytest

from benchmark import harness
from benchmark.trace import Trace
from benchmark.tests import tiny


def _x(name, cat, ts, dur, card=None, pid=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if card is not None:
        e["args"] = {"device": card, "stream": 7}
    if pid is not None:
        e["pid"] = pid
    return e


def one_card_events():
    """A window of about 20 ms on card 0: stages on the host, the
    program's kernels, a library kernel over one of them, copies and a
    memset, an operation that starts before the window."""
    u = "user_annotation"
    return [
        _x("bench:window", u, 1000.25, 20000.5),
        _x("stage:read_fasta", u, 1000.25, 3999.75),
        _x("stage:upload", u, 5000.5, 700.125),
        _x("stage:sort", u, 6100.0, 4100.375),
        _x("stage:pull", u, 11000.0, 1500.25),
        _x("stage:decode+group", u, 13000.5, 6000.0),
        _x("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 5010.5, 650.75,
           0, 0),
        _x("void (anonymous namespace)::window_keys_kernel<true>"
           "(unsigned char const*)", "kernel", 5800.125, 180.5, 0, 0),
        _x("(anonymous namespace)::vary_kernel(unsigned int const*)",
           "kernel", 6200.0, 60.25, 0, 0),
        _x("(anonymous namespace)::histogram_kernel(unsigned int const*)",
           "kernel", 6300.5, 140.0, 0, 0),
        _x("void (anonymous namespace)::onesweep_kernel<2>(Rows, long)",
           "kernel", 6500.0, 2900.625, 0, 0),
        _x("void at::native::vectorized_elementwise_kernel<4>(int)",
           "kernel", 9000.0, 700.0, 0, 0),
        _x("(anonymous namespace)::scan_kernel(unsigned int const*, int)",
           "kernel", 10000.25, 410.5, 0, 0),
        _x("(anonymous namespace)::patch_kernel(unsigned int*)", "kernel",
           10450.0, 30.25, 0, 0),
        _x("Memset (Device)", "gpu_memset", 10500.0, 4.5, 0, 0),
        _x("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 11100.0,
           900.375, 0, 0),
        _x("void at::native::index_elementwise_kernel<128, 4>(int)",
           "kernel", 500.0, 800.0, 0, 0),
        _x("aten::sort", "cpu_op", 6100.0, 30.0),
    ]


def record(trace):
    """A run record of two searches over ``trace``."""
    stages = {"read_fasta": {"seconds": 2.125, "calls": 10, "items": 0},
              "detect_bits": {"seconds": 2.75, "calls": 2, "items": 4000},
              "stack": {"seconds": 0.1875, "calls": 2, "items": 4096},
              "upload": {"seconds": 0.0625, "calls": 10, "items": 4096},
              "sort": {"seconds": 0.5, "calls": 2, "items": 30_000},
              "pull": {"seconds": 0.0375, "calls": 2, "items": 1234},
              "decode": {"seconds": 0.625, "calls": 2, "items": 1234},
              "decode+group": {"seconds": 1.5, "calls": 2, "items": 1234},
              "filter": {"seconds": 0.25, "calls": 2, "items": 300},
              "render": {"seconds": 0.0125, "calls": 2, "items": 150}}
    half = {k: {kk: v / 2 for kk, v in s.items()} for k, s in stages.items()}
    return harness.Run(
        setup_s=14.375, window_s=11.5, work=800_000_000,
        searches=[{"wall_s": 5.75, "work": 400_000_000, "stages": half}] * 2,
        stages=stages, peak_bytes=9_710_871_040,
        problem={"kmers": 20_000, "bases": 10_000, "key_words": 2},
        trace=trace)


#: What the harness read from this record and trace before it counted
#: cards, to the last bit: the trace's numbers, and every per-layer
#: metric of BENCHMARK.json (None: left out of the line).
BEFORE = {
    "window_s": 0.0200005,
    "busy_s": 0.005876875,
    "idle_gaps": [["decode+group", 0.006], ["read_fasta", 0.0037],
                  ["outside stages", 0.003274375], ["pull", 0.000599875],
                  ["sort", 0.0005], ["upload", 4.9375e-05]],
    "device_ops": [["onesweep_kernel", 0.002900625],
                   ["Memcpy DtoH (Device -> Pageable)", 0.000900375],
                   ["void at::native::vectorized_elementwise_kernel<4>(int)",
                    0.0007],
                   ["Memcpy HtoD (Pageable -> Device)", 0.00065075],
                   ["scan_kernel", 0.0004105],
                   ["void at::native::index_elementwise_kernel<128, 4>(int)",
                    0.00029975],
                   ["window_keys_kernel", 0.0001805],
                   ["histogram_kernel", 0.00014],
                   ["vary_kernel", 6.025e-05], ["patch_kernel", 3.025e-05]],
    "metrics": {
        "read_fasta_s": 1.0625, "pack_upload_s": 0.03125,
        "prefilter_s": None,
        "window_keys.roofline_pct": 0.056228552528217644,
        "sort_words.roofline_pct": 0.004620746792100689,
        "survivor_scan.roofline_pct": 0.017591723740909747,
        "decode_group_s": 0.75, "untracked_s": 1.7249999999999996,
        "device_idle_pct": 70.61635959101022, "detect_bits_s": 1.375,
        "stack_s": 0.09375, "decode_s": 0.3125, "filter_s": 0.125,
        "render_s": 0.00625},
}


def _readings(trace: Trace) -> dict:
    run = record(trace)
    return {"window_s": trace.window_s, "busy_s": trace.busy_s,
            "idle_gaps": trace.idle_gaps(), "device_ops": trace.device_ops(),
            "metrics": {name: harness.load_reader(name)(run)
                        for name in BEFORE["metrics"]}}


def test_one_card_reads_as_before():
    """Every number equal to the bit, also where the card count is given
    and where the events name their card by ``pid`` alone."""
    events = one_card_events()
    assert _readings(Trace(events)) == BEFORE
    assert _readings(Trace(events, cards=1)) == BEFORE
    by_pid = [{k: v for k, v in e.items() if k != "args"} for e in events]
    assert _readings(Trace(by_pid)) == BEFORE


def test_end_to_end_readers_read_as_before():
    run = record(None)
    assert harness.load_reader("peak_device_gib")(run) == \
        9_710_871_040 / 2**30
    assert harness.load_reader("kmers_per_s")(run) == 800_000_000 / 11.5


def _two_card_events():
    """A 10 ms window.  Card 0 (``args.device``) busy [1, 3] and [2, 4]
    ms, card 1 (``pid`` alone) busy [2, 7] ms; the host in stage ``sort``
    over [0, 5] ms."""
    u = "user_annotation"
    return [_x("bench:window", u, 0.0, 10000.0),
            _x("stage:sort", u, 0.0, 5000.0),
            _x("(anonymous namespace)::onesweep_kernel<2>()", "kernel",
               1000.0, 2000.0, 0, 0),
            _x("(anonymous namespace)::scan_kernel()", "kernel", 2000.0,
               2000.0, 0, 0),
            _x("(anonymous namespace)::onesweep_kernel<2>()", "kernel",
               2000.0, 5000.0, pid=1)]


def test_two_cards_each_their_own():
    t = Trace(_two_card_events(), cards=2)
    assert t.cards == 2 and sorted(t.card_ids) == [0, 1]
    # card 0 busy 3 ms, card 1 5 ms: the mean 4 ms, not the union's 6
    assert t.busy_s == pytest.approx(0.004)
    run = harness.Run(setup_s=1.0, trace=t)
    assert harness.load_reader("device_idle_pct")(run) == \
        pytest.approx(60.0)
    # card 0 idle [0, 1] (sort) and [4, 10] (sort 1, outside 5); card 1
    # idle [0, 2] (sort) and [7, 10] (outside 3): halved
    gaps = dict(t.idle_gaps())
    assert gaps["sort"] == pytest.approx((0.001 + 0.001 + 0.002) / 2)
    assert gaps["outside stages"] == pytest.approx((0.005 + 0.003) / 2)
    # kernel time sums every launch on every card: card-seconds
    assert t.kernel_seconds(["onesweep_kernel"]) == pytest.approx(0.007)
    assert dict(t.device_ops())["onesweep_kernel"] == pytest.approx(0.007)


def test_a_card_that_ran_nothing_is_idle():
    """Four cards asked for, the operations on card 0 alone: three cards
    idle all through the window."""
    t = Trace(_two_card_events()[:4], cards=4)
    assert t.cards == 4 and t.card_ids == [0]
    assert t.busy_s == pytest.approx(0.003 / 4)
    gaps = dict(t.idle_gaps())
    assert gaps["sort"] == pytest.approx((0.002 + 3 * 0.005) / 4)
    assert gaps["outside stages"] == pytest.approx((0.005 + 3 * 0.005) / 4)
    # more cards in the trace than given: every card counts
    assert Trace(_two_card_events(), cards=1).cards == 2


class FakeCards:
    """``torch.cuda``'s per-card statistics over ``n`` cards: each card's
    allocations served, its peak since the last reset, its name."""

    def __init__(self, n, names=None):
        self.allocs = [0] * n
        self.current = [0] * n
        self.peak = [0] * n
        self.names = names or ["NVIDIA H100 80GB HBM3"] * n

    def allocate(self, card, n_bytes):
        self.allocs[card] += 1
        self.current[card] += n_bytes
        self.peak[card] = max(self.peak[card], self.current[card])

    def free(self, card, n_bytes):
        self.current[card] -= n_bytes

    def patch(self, monkeypatch):
        cuda = harness.torch.cuda
        monkeypatch.setattr(cuda, "device_count", lambda: len(self.allocs))
        monkeypatch.setattr(cuda, "memory_stats", lambda i: {
            "allocation.all.allocated": self.allocs[i],
            "allocated_bytes.all.current": self.current[i]})
        monkeypatch.setattr(cuda, "reset_peak_memory_stats",
                            lambda i: self.peak.__setitem__(
                                i, self.current[i]))
        monkeypatch.setattr(cuda, "max_memory_allocated",
                            lambda i: self.peak[i])
        monkeypatch.setattr(cuda, "get_device_name", lambda i: self.names[i])


def _window(work):
    run = harness.Run(setup_s=1.0)
    before = harness._window_start()
    work()
    harness._window_end(run, before)
    return run


def test_device_info_counts_the_cards_and_reads_the_fullest(monkeypatch):
    cards = FakeCards(4)
    cards.patch(monkeypatch)

    def search():
        for i, n in enumerate((5 << 30, 9 << 30, 7 << 30, 6 << 30)):
            cards.allocate(i, n)
            cards.free(i, n)
    run = _window(search)
    assert run.cards_used == [0, 1, 2, 3]
    assert run.card_peaks == [5 << 30, 9 << 30, 7 << 30, 6 << 30]
    info = harness._device_info("cuda", run)
    assert info == {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                    "count": 4, "memory_peak_bytes": 9 << 30}


def test_a_tensor_left_from_set_up_counts_for_nothing(monkeypatch):
    """Card 1 holds 2 GiB from set-up and serves nothing in the window: one
    card used, card 0, and the peak is card 1's held bytes only where
    they are the most."""
    cards = FakeCards(2)
    cards.patch(monkeypatch)
    cards.allocate(1, 2 << 30)
    run = _window(lambda: cards.allocate(0, 1 << 30))
    assert run.cards_used == [0]
    assert run.card_peaks == [1 << 30, 2 << 30]
    assert harness._device_info("cuda", run)["count"] == 1


def test_cards_of_different_kinds_fail(monkeypatch):
    cards = FakeCards(2, ["NVIDIA H100 80GB HBM3", "NVIDIA A100-SXM4-80GB"])
    cards.patch(monkeypatch)

    def search():
        cards.allocate(0, 1)
        cards.allocate(1, 1)
    run = _window(search)
    with pytest.raises(harness.CardsUsed):
        harness._device_info("cuda", run)


@pytest.mark.parametrize("chips", [1, 4])
def test_entry_hands_the_program_the_cells_cards(tmp_path, chips):
    from benchmark.entries.krisp_fasta import Entry
    e = Entry(tiny.config("spacer-5x40Mb"), tiny.traffic("distant"), 1,
              tmp_path, "cuda", chips)

    class G:
        ingroup, outgroup = ["a.fa"], ["b.fa", "c.fa"]
    e.genomes = G
    argv = e.argv("s0")
    i = argv.index("--devices")
    assert argv[i + 1] == str(chips)
    assert argv.count("--devices") == 1


def _tiny_run_cell(**kw):
    return harness.run_cell(tiny.config("spacer-5x40Mb", 40_000),
                            tiny.traffic("distant"), "tiny",
                            [{"name": "kmers_per_s", "unit": "kmers/s"}], [],
                            7, 0.1, False, "cpu", **kw)


def test_run_cell_fails_where_the_window_used_fewer_cards():
    """On the CPU the program runs on one device whatever it is asked."""
    assert _tiny_run_cell(chips=1)["device"]["count"] == 1
    with pytest.raises(harness.CardsUsed, match="asks for 4 card"):
        _tiny_run_cell(chips=4)


def _load_run_py(monkeypatch):
    """``benchmark/run.py`` as a module, its changes to the module path
    and the environment undone after the test."""
    monkeypatch.setattr("sys.path", list(__import__("sys").path))
    for var in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR"):
        monkeypatch.setenv(var, "unset")
    spec = importlib.util.spec_from_file_location(
        "benchmark_run_py", tiny.BENCH / "run.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_run_py_prints_no_result_where_the_cards_used_differ(monkeypatch,
                                                             capsys):
    """A cell of 4 chips on a machine of 4 cards whose window ran on one:
    a code other than 0, a message naming both counts, no result line."""
    run_py = _load_run_py(monkeypatch)
    cell = {"name": "tiny4", "config": "spacer-5x40Mb", "traffic": "distant",
            "chips": 4}
    monkeypatch.setattr(harness, "cell_inputs", lambda m, n: (
        cell, tiny.config("spacer-5x40Mb", 40_000), tiny.traffic("distant")))
    monkeypatch.setattr(harness.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(harness.torch.cuda, "device_count", lambda: 4)
    run_cell = harness.run_cell

    def on_the_cpu(*args):
        return run_cell(*args[:8], "cpu", args[9], args[10])
    monkeypatch.setattr(harness, "run_cell", on_the_cpu)
    rc = run_py.main(["--workload", "tiny4", "--seed", "11", "--seconds",
                      "0.1", "--trace", "0"])
    out, err = capsys.readouterr()
    assert rc != 0
    assert out.strip() == ""
    assert "asks for 4 card(s)" in err and "the window used 1" in err


@pytest.mark.parametrize("name", sorted(
    m["name"] for m in tiny.manifest()["per_layer"]
    if m["name"].endswith(".related")))
def test_a_related_cells_reader_reads_as_its_base(name):
    """``<metric>.related`` gives what ``<metric>`` gives on the same
    record and trace."""
    run = record(Trace(one_card_events()))
    base = name[:-len(".related")]
    want = BEFORE["metrics"].get(base, harness.load_reader(base)(run))
    assert want is not None
    assert harness.load_reader(name)(run) == want
