"""BENCHMARK.json keeps to the benchmark's contract, and every name in it
resolves to a file of the harness."""

import json
import re

import pytest

from benchmark.tests import tiny

M = tiny.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
E2E = {m["name"] for m in M["end_to_end"]}
CELLS = {w["name"] for w in M["workloads"]}
RATE = next(m for m in M["end_to_end"] if m["name"] == "kmers_per_s")


def _line(text, limit=200):
    return (isinstance(text, str) and 1 <= len(text) <= limit
            and "\n" not in text and "\t" not in text)


def test_top_level_keys_and_size():
    assert set(M) == TOP
    assert len((tiny.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= M["run_seconds"] <= 51 and isinstance(M["run_seconds"], int)
    assert M["paths"] == ["benchmark"]
    assert M["command"] == ["python3", "benchmark/run.py"]
    assert all(_line(w) for w in M["command"])


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_have_just_their_keys_and_clean_names(section):
    entries = M[section]
    assert entries, section
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
    for e in entries:
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert _line(e[key]), (e["name"], key)


def test_metric_names_unique_across_sections():
    names = [m["name"] for m in M["end_to_end"] + M["per_layer"]]
    assert len(names) == len(set(names))


def test_configs_resolve_and_keep_their_source():
    used = {w["config"] for w in M["workloads"]}
    files = [c["file"] for c in M["configs"]]
    assert len(files) == len(set(files))
    for c in M["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("benchmark/")
        body = json.loads((tiny.ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert c["source"].startswith("https://")
        assert c["reduced"] == body["reduced"]
        assert all(NAME.match(k) for k in c["reduced"])
        assert (tiny.BENCH / "entries" / f"{body['entry']}.py").exists()


@pytest.mark.parametrize("name", tiny.CONFIGS)
def test_config_window_follows_its_flags(name):
    """The window split is the README's arithmetic on the flags."""
    c = tiny.config(name)
    f = dict(zip(c["flags"][::2], map(int, c["flags"][1::2])))
    w = c["window"]
    if "--amplicon" in f:
        assert w["left"] == w["right"] == f["--conserved"]
        assert w["mid"] == f["--amplicon"] - 2 * f["--conserved"]
    else:
        assert (w["left"], w["mid"], w["right"]) == (
            f["--conserved-left"], f["--diagnostic"], f["--conserved-right"])
    assert 1 <= c["ingroup"] < c["genomes"]


def test_cells_resolve():
    configs = {c["name"] for c in M["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in M["workloads"])
    assert four <= max(1, len(M["workloads"]) // 4)
    for w in M["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"])
        assert (tiny.BENCH / "traffic" / f"{w['traffic']}.json").exists()


def test_end_to_end_bounds():
    assert "setup_s" in E2E
    for m in M["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", CELLS)) <= CELLS


def test_per_layer_metrics_resolve():
    for m in M["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in E2E
        mover = next(e for e in M["end_to_end"] if e["name"] == m["moves"])
        cells = set(m["workloads"])
        if m["moves"] == "setup_s":   # only where the rate is not end to end
            assert not cells & set(RATE["workloads"]), m["name"]
        assert cells <= CELLS
        assert cells <= set(mover.get("workloads", CELLS))
        if m["name"].endswith("_roofline") or "roofline" in m["name"]:
            assert m["unit"] == "%"
    layers = {}
    for m in M["per_layer"]:   # one layer, one name
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("metric", [m["name"] for m in M["end_to_end"]
                                    + M["per_layer"]])
def test_every_metric_has_a_reader(metric):
    from benchmark import harness
    assert callable(harness.load_reader(metric))


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_every_cell_reports_enough(cell):
    from benchmark import harness
    e2e = {m["name"] for m in harness.cell_metrics(M, cell, "end_to_end")}
    layer = harness.cell_metrics(M, cell, "per_layer")
    assert "setup_s" in e2e and len(e2e) >= 2
    assert layer
    harness.cell_inputs(M, cell)


def test_run_seconds_fits_the_full_check():
    """24 cells at this length fit the check's 43,200 s."""
    runs = 2 + 14 * 24
    assert runs * (M["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_rate_is_end_to_end_or_per_layer(cell):
    """A cell whose rate spreads past any bound reports it per layer, as
    ``kmers_per_s.<mix>``, and reads every stage there too."""
    from benchmark import harness
    e2e = {m["name"] for m in harness.cell_metrics(M, cell, "end_to_end")}
    layer = {m["name"] for m in harness.cell_metrics(M, cell, "per_layer")}
    mix = next(w["traffic"] for w in M["workloads"] if w["name"] == cell)
    assert ("kmers_per_s" in e2e) != (f"kmers_per_s.{mix}" in layer)
    if "kmers_per_s" not in e2e:
        assert {n + "." + mix for n in ("decode_group_s", "read_fasta_s",
                                         "device_idle_pct")} <= layer
