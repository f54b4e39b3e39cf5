"""The port's program spans: ``metrics.span`` and the ``krisp:<stage>``
span of every ``Metrics.stage`` call, the whole-search span ``krisp_fasta``
and ``--profile-dir``, on a CPU search over tiny genomes."""

import json
from collections import Counter

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from krisp_tpu_torch import metrics
from krisp_tpu_torch.cli.krisp_fasta import main
from krisp_tpu_torch.io.fasta import bucket_size, load_buffer
from krisp_tpu_torch.metrics import GLOBAL as METRICS

GEOM = ("--conserved-left", "25", "--conserved-right", "2",
        "--diagnostic", "1")
#: host steps of a search outside the device stages
NEW_STAGES = ("detect_bits", "stack", "decode", "filter", "render")


def _genomes(tmp_path, seed=3, n_files=3, ingroup=2):
    """Random records plus planted 28-base windows: one every genome holds
    (the filter drops it) and one whose middle base tells the ingroup
    apart (it passes), so the search writes CSV rows."""
    rng = np.random.default_rng(seed)

    def bases(n, alphabet="ACGT"):
        return "".join(rng.choice(list(alphabet), size=n))
    shared, left, right = bases(40), bases(25), bases(2)
    paths = []
    for f in range(n_files):
        seqs = [bases(int(rng.integers(200, 600)), "ACGTNacgt")
                for _ in range(3)]
        seqs += [shared, "GG" + left + ("A" if f < ingroup else "G") + right
                 + "CC"]
        path = tmp_path / f"g{f}.fasta"
        path.write_text("".join(f">s{i}\n{s}\n" for i, s in enumerate(seqs)))
        paths.append(str(path))
    return paths[:ingroup], paths[ingroup:]


def _search(tmp_path, *extra):
    """One CLI search on the CPU with the stages reset before it; returns
    the CSV's path and the genomes' buffer sizes."""
    ins, outs = _genomes(tmp_path)
    csv = tmp_path / "out.csv"
    METRICS.reset()
    assert main([*ins, "--outgroup", *outs, *GEOM, "--device", "cpu",
                 "-s", str(csv), "-o", str(tmp_path / "out.txt"),
                 *extra]) == 0
    return csv, [load_buffer(p).size for p in ins + outs]


def _spans(prof, tmp_path):
    """(name, start, end) of the user spans of a finished profile."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


@pytest.fixture
def counted(monkeypatch):
    """``metrics.record_function`` replaced by one that counts its
    calls."""
    calls = []
    real = metrics.record_function

    def counting(name):
        calls.append(name)
        return real(name)
    monkeypatch.setattr(metrics, "record_function", counting)
    return calls


def test_stage_opens_no_span_without_a_profiler(counted):
    m = metrics.Metrics()
    for _ in range(3):
        with m.stage("x", items=2):
            pass
    assert counted == []
    assert (m.stages["x"].calls, m.stages["x"].items) == (3, 6)


def test_stage_opens_one_span_a_call_under_a_profiler(counted):
    m = metrics.Metrics()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            with m.stage("x"):
                pass
    assert counted == ["krisp:x"] * 3


def test_search_leaves_one_span_per_stage_call_inside_its_own(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _search(tmp_path)
    spans = _spans(prof, tmp_path)
    search = [s for s in spans if s[0] == "krisp_fasta"]
    assert len(search) == 1
    _, start, end = search[0]
    stages = sorted((s for s in spans if s[0].startswith("krisp:")),
                    key=lambda s: s[1])
    seen = Counter(name[len("krisp:"):] for name, _, _ in stages)
    assert seen == {k: s.calls for k, s in METRICS.stages.items()}
    assert set(NEW_STAGES) <= set(seen)
    assert all(start <= a and b <= end for _, a, b in stages)
    assert all(b <= a2 for (_, _, b), (_, a2, _) in zip(stages, stages[1:]))


def test_search_counts_every_host_step(tmp_path):
    csv, sizes = _search(tmp_path)
    st = METRICS.stages
    assert set(NEW_STAGES) <= set(st)
    assert st["decode"].items == st["pull"].items > 0
    assert st["decode+group"].items == st["pull"].items
    rows = csv.read_text().count("\n") - 1
    assert rows > 0 and st["render"].items == rows
    assert st["filter"].items >= rows
    assert st["stack"].items == len(sizes) * bucket_size(max(sizes))
    assert st["detect_bits"].items == sum(sizes)


def test_profile_dir_covers_the_render_and_the_writes(tmp_path):
    prof_dir = tmp_path / "prof"
    _search(tmp_path, "--profile-dir", str(prof_dir))
    traces = list(prof_dir.glob("*.pt.trace.json"))
    assert len(traces) == 1
    names = {e.get("name") for e in
             json.loads(traces[0].read_text())["traceEvents"]}
    assert {"krisp_fasta", "krisp:read_fasta", "krisp:render"} <= names
