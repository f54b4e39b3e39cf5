"""The metric arithmetic on synthetic records: the rate over a window of
whole searches, stage seconds a search, the device's idle share and the
roofline shares from a synthetic trace."""

import json

import pytest

from benchmark import harness, problem
from benchmark.trace import Trace, kernel_id


def _run(**kw):
    run = harness.Run(setup_s=12.5, problem={
        "kmers": 1000, "bases": 600, "key_words": 2})
    for k, v in kw.items():
        setattr(run, k, v)
    return run


def read(name, run):
    return harness.load_reader(name)(run)


def test_rate_over_whole_searches():
    searches = [{"wall_s": 2.0, "work": 1000, "stages": {}},
                {"wall_s": 3.0, "work": 1000, "stages": {}}]
    run = _run(searches=searches, work=2000, window_s=5.0)
    assert read("kmers_per_s", run) == pytest.approx(400.0)
    assert read("setup_s", run) == 12.5
    assert read("peak_device_gib", _run(peak_bytes=3 * 2**30)) == 3.0
    assert read("kmers_per_s", _run()) is None


def test_stage_seconds_a_search():
    st = {"read_fasta": {"seconds": 1.0, "calls": 2, "items": 0},
          "pack+upload": {"seconds": 2.0, "calls": 10, "items": 50},
          "decode+group": {"seconds": 0.5, "calls": 2, "items": 0}}
    searches = [{"wall_s": 2.5, "work": 1, "stages": {
        "read_fasta": {"seconds": 0.5}, "pack+upload": {"seconds": 1.0},
        "decode+group": {"seconds": 0.25}}}] * 2
    run = _run(stages=st, searches=searches)
    assert read("read_fasta_s", run) == 0.5
    assert read("pack_upload_s", run) == 1.0
    assert read("decode_group_s", run) == 0.25
    assert read("untracked_s", run) == pytest.approx(0.75)
    assert read("prefilter_s", run) is None   # no prefilter stage ran


def _events():
    """A 10 ms window: two kernels of the program, one library kernel
    overlapping the second, a copy; the host in two stages."""
    def x(name, cat, ts, dur):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    return [x("bench:window", "user_annotation", 1000.0, 10000.0),
            x("stage:read_fasta", "user_annotation", 1000.0, 3000.0),
            x("stage:sort", "user_annotation", 4000.0, 6000.0),
            x("void (anonymous namespace)::onesweep_kernel<2>(Rows, long)",
              "kernel", 4500.0, 1000.0),
            x("(anonymous namespace)::scan_kernel(unsigned int const*, int)",
              "kernel", 6000.0, 500.0),
            x("void at::native::elementwise_kernel<128, 2>(int)", "kernel",
              6200.0, 800.0),
            x("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 9000.0,
              1000.0),
            x("aten::add", "cpu_op", 5000.0, 10.0)]


def test_trace_busy_idle_and_gaps(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": _events()}))
    t = Trace.load(path)
    assert t.window_s == pytest.approx(0.010)
    # busy: [4500, 5500] + [6000, 7000] + [9000, 10000] = 3 ms
    assert t.busy_s == pytest.approx(0.003)
    run = _run(trace=t, searches=[{}] * 1)
    assert read("device_idle_pct", run) == pytest.approx(70.0)
    gaps = dict(t.idle_gaps())
    # idle: [1000, 4500] (read_fasta 3000 of it, sort 500), [5500, 6000]
    # and [7000, 9000] (sort), [10000, 11000] (no stage)
    assert gaps["read_fasta"] == pytest.approx(0.003)
    assert gaps["sort"] == pytest.approx(0.0005 + 0.0005 + 0.002)
    assert gaps["outside stages"] == pytest.approx(0.001)
    ops = dict(t.device_ops())
    assert ops["onesweep_kernel"] == pytest.approx(0.001)
    assert t.kernel_seconds(["scan_kernel"]) == pytest.approx(0.0005)
    assert t.kernel_seconds(["elementwise_kernel"]) == 0


def test_kernel_names():
    assert kernel_id("window_keys_kernel") == "window_keys_kernel"
    assert kernel_id("void (anonymous namespace)::window_keys_kernel<true>"
                     "(unsigned char const*)") == "window_keys_kernel"
    assert kernel_id("void cub::DeviceRadixSortOnesweepKernel<x>()") is None
    assert kernel_id("Memcpy HtoD (Pageable -> Device)") is None


def test_roofline_shares(tmp_path):
    events = [{"ph": "X", "name": "bench:window", "cat": "user_annotation",
               "ts": 0.0, "dur": 1e6}]
    for name, dur in (("window_keys_kernel", 100.0),
                      ("(anonymous namespace)::onesweep_kernel<2>()", 200.0),
                      ("(anonymous namespace)::vary_kernel()", 50.0),
                      ("(anonymous namespace)::scan_kernel()", 40.0),
                      ("(anonymous namespace)::patch_kernel()", 10.0)):
        events.append({"ph": "X", "name": name, "cat": "kernel", "ts": 10.0,
                       "dur": dur})
    t = Trace(events)
    st = {"sort": {"seconds": 1.0, "calls": 2, "items": 4_000_000},
          "pull": {"seconds": 0.1, "calls": 2, "items": 100}}
    run = _run(trace=t, stages=st, searches=[{}, {}])
    peak = problem.PEAK_BYTES_PER_S
    # window keys: 2 searches x (600 bases + 1000 rows x 8 B) in 100 us
    assert read("window_keys.roofline_pct", run) == pytest.approx(
        100 * 2 * 8600 / peak / 100e-6)
    assert read("sort_words.roofline_pct", run) == pytest.approx(
        100 * 2 * 4_000_000 * 8 / peak / 250e-6)
    assert read("survivor_scan.roofline_pct", run) == pytest.approx(
        100 * (4_000_000 * 8 + 100 * 16) / peak / 50e-6)
    # no kernel of its own in the trace: the metric is left out, never 0
    bare = _run(trace=Trace(events[:1]), stages=st, searches=[{}])
    assert read("window_keys.roofline_pct", bare) is None
    assert read("sort_words.roofline_pct", bare) is None


def test_key_words():
    assert problem.key_words(28, 2, 5) == 2
    assert problem.key_words(100, 2, 5) == 7
    assert problem.key_words(28, 4, 5) == 4
    assert problem.kmers([[100, 50], [100, 50]], 28) == 2 * 2 * (73 + 23)
