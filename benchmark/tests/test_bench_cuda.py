"""One cell for a few seconds on the card, as the benchmark runs it.  Skips
where there is no CUDA card (decided inside the test)."""

import json
import subprocess
import sys

import pytest

from benchmark.tests import tiny


@pytest.mark.cuda
def test_cell_runs_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is false")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "spacer-5x40Mb.distant", "--seed", "4242",
                          "--seconds", "2", "--trace", "0"],
                         capture_output=True, text=True, timeout=900,
                         cwd=tiny.ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    assert {"kmers_per_s", "peak_device_gib", "setup_s"} <= set(r["metrics"])
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
