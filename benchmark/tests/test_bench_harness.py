"""The harness end to end on the CPU at a small size (the program's plain
PyTorch path): a sound run is correct; a run with the timed path broken
underneath is not; no module of JAX or of krisp_tpu is loaded; and
``run.py`` prints no result where it cannot run."""

import json
import shutil
import subprocess
import sys

import numpy as np
import pytest

from benchmark import harness
from benchmark.tests import tiny

E2E = [{"name": "kmers_per_s", "unit": "kmers/s"},
       {"name": "setup_s", "unit": "s"}]
LAYER = [{"name": n, "unit": "s"} for n in
         ("read_fasta_s", "pack_upload_s", "prefilter_s", "decode_group_s",
          "untracked_s")]


def _run(config="spacer-5x40Mb", mix="distant", bases=60_000, trace=False,
         seed=2**31 + 5):
    return harness.run_cell(tiny.config(config, bases), tiny.traffic(mix),
                            "tiny", E2E, LAYER, seed, 0.2, trace, "cpu")


@pytest.mark.parametrize("config,mix", [("spacer-5x40Mb", "distant"),
                                        ("amplicon-5x40Mb", "distant"),
                                        ("spacer-5x40Mb", "related"),
                                        ("spacer-5x40Mb", "iupac")])
def test_sound_run_is_correct(config, mix):
    r = _run(config, mix)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["metrics"]) == {"kmers_per_s", "setup_s"}
    assert list(r)[-1] == "checks"
    assert all(v["value"] == 0 == v["limit"] for v in r["checks"].values())


def test_traced_run_reports_per_layer_metrics():
    r = _run("amplicon-5x40Mb", trace=True)
    assert r["correct"]
    assert {"read_fasta_s", "pack_upload_s", "prefilter_s",
            "decode_group_s", "untracked_s"} <= set(r["metrics"])
    assert "breakdown" in r and r["device"]["window_s"] > 0


def _fault_state_unchanged(monkeypatch):
    """The search returns as it started: no group found."""
    import krisp_tpu_torch.engine.pipeline as pipeline
    monkeypatch.setattr(pipeline, "run_pipeline", lambda *a, **k: [])


def _fault_half_left_out(monkeypatch):
    """Half of every genome left out of the search."""
    import krisp_tpu_torch.engine.pipeline as pipeline
    load = pipeline.load_buffer

    def half(path):
        buf = load(path)
        return np.ascontiguousarray(buf[:buf.size // 2])
    monkeypatch.setattr(pipeline, "load_buffer", half)


def _fault_answer_altered(monkeypatch):
    """One CSV row altered where it is produced."""
    import krisp_tpu_torch.engine.render as render
    row = render.render_csv
    seen = []

    def altered(group, *a, **k):
        text = row(group, *a, **k)
        seen.append(text)
        if len(seen) == 1:
            i = text.index(",") + 1
            text = text[:i] + "ACGT"[("ACGT".index(text[i]) + 1) % 4] \
                + text[i + 1:]
        return text
    monkeypatch.setattr(render, "render_csv", altered)


@pytest.mark.parametrize("fault", [_fault_state_unchanged,
                                   _fault_half_left_out,
                                   _fault_answer_altered])
@pytest.mark.parametrize("config", ["spacer-5x40Mb", "amplicon-5x40Mb"])
def test_broken_timed_path_is_not_correct(monkeypatch, fault, config):
    fault(monkeypatch)
    r = _run(config)
    assert not r["correct"]
    assert r["checks"]["searches_wrong"]["value"] >= 1


def test_no_jax_or_krisp_tpu_loaded():
    """A whole CPU run in a fresh process, then the loaded modules by
    top-level name."""
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(tiny.ROOT)!r})\n"
        "from benchmark import harness\n"
        "from benchmark.tests import tiny\n"
        "r = harness.run_cell(tiny.config('spacer-5x40Mb', 40_000),\n"
        "    tiny.traffic('distant'), 'tiny',\n"
        "    [{'name': 'kmers_per_s', 'unit': 'kmers/s'}], [], 3, 0.1,\n"
        "    False, 'cpu')\n"
        "assert r['correct'], r\n"
        "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tiny.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "krisp_tpu_torch_x", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "krisp_tpu.engine", sys)
    assert harness.forbidden_modules() == ["krisp_tpu"]


def test_run_py_prints_no_result_without_a_card():
    """Where there is no CUDA card: a non-zero exit, nothing on
    standard output."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "spacer-5x40Mb.distant", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120,
                         cwd=tiny.ROOT)
    assert out.returncode != 0 and out.stdout == ""


def test_run_py_refuses_a_folder_of_the_benchmark_alone(tmp_path):
    shutil.copy(tiny.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(tiny.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "spacer-5x40Mb.distant", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120,
                         cwd=tmp_path)
    assert out.returncode != 0 and out.stdout == ""


def test_result_line_is_last_and_parses(capsys):
    r = {"correct": True, "attempted": 1, "failed": 0, "metrics": {},
         "device": {}, "checks": {"csv_lines_wrong": {"value": 0,
                                                      "limit": 0}}}
    harness.print_result(r)
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == r
    assert err.strip().splitlines()[-1] == "check csv_lines_wrong 0 limit 0"
