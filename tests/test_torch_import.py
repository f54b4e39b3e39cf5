"""The PyTorch port imports without JAX, CUDA or nvcc, and never falls back
to the CPU unless asked."""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent


def test_port_imports_without_jax():
    # a subprocess: this test process already imported jax (conftest.py);
    # importing builds and loads no kernel (the build is lazy)
    code = ("import sys\n"
            "import krisp_tpu_torch\n"
            "import krisp_tpu_torch.engine.pipeline\n"
            "import krisp_tpu_torch.cli.krisp_fasta\n"
            "import krisp_tpu_torch.ops.pack, krisp_tpu_torch.ops.scan\n"
            "import krisp_tpu_torch.ops.sort, krisp_tpu_torch.ops.encode\n"
            "import krisp_tpu_torch.ops.intersect, krisp_tpu_torch.convert\n"
            "from krisp_tpu_torch.ops.sort import sort_words, sort_rows\n"
            "from krisp_tpu_torch.ops.intersect import ("
            "global_stage, fused_prefilter_global, extract_keys_ascii,"
            " global_intersect_bits, dedup_sorted)\n"
            "import krisp_tpu_torch.ops.merge\n"
            "import krisp_tpu_torch.engine.bigscale\n"
            "import krisp_tpu_torch.tools.ab_merge_path\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "assert 'triton' not in sys.modules\n"
            "from krisp_tpu_torch.kernels import build\n"
            "assert build.load_library.cache_info().currsize == 0\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_no_jax_import_in_port_sources():
    for path in (REPO / "krisp_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            stripped = line.strip()
            assert not stripped.startswith(("import jax", "from jax")), path


def test_cuda_request_without_cuda_raises():
    from krisp_tpu_torch import resolve_device
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_pipeline_default_device_raises_without_cuda(tmp_path):
    from krisp_tpu_torch.engine.pipeline import KmerGeometry, run_pipeline
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = tmp_path / "g.fasta"
    p.write_text(">a\nACGTACGTACGT\n")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        run_pipeline([str(p)], [], KmerGeometry(4, 1, 3))


def _planted_genomes(tmp_path):
    """Three genomes sharing 30-base flanks around a 40-base middle that
    differs between the ingroup (genomes 0-1) and the outgroup."""
    rng = np.random.default_rng(4)
    fl, fr, mid = ("".join(rng.choice(list("ACGT"), k)) for k in (30, 30, 40))
    mid_out = mid.translate(str.maketrans("ACGT", "CATG"))
    paths = []
    for f in range(3):
        body = "".join(rng.choice(list("ACGT"), 600))
        seq = body[:300] + fl + (mid if f < 2 else mid_out) + fr + body[300:]
        path = tmp_path / f"g{f}.fasta"
        path.write_text(f">g{f}\n{seq}\n")
        paths.append(str(path))
    return paths


@pytest.mark.parametrize("flags", [["--primer3"], ["--workdir", "tables"]])
def test_port_cli_loads_no_krisp_tpu_module(tmp_path, flags):
    """The port's CLI on the CPU, with primer design or with the table
    cache, leaves no module of the JAX package loaded."""
    paths = _planted_genomes(tmp_path)
    flags = [str(tmp_path / f) if f == "tables" else f for f in flags]
    argv = [*paths[:2], "--outgroup", paths[2], "--conserved", "30",
            "--amplicon", "100", "--device", "cpu", "--out_csv",
            str(tmp_path / "out.csv"), *flags]
    code = ("import sys\n"
            "from krisp_tpu_torch.cli.krisp_fasta import main\n"
            f"assert main({argv!r}) == 0\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m == 'krisp_tpu' or m.startswith('krisp_tpu.'))\n"
            "assert not bad, bad\n"
            "assert 'jax' not in sys.modules\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
    rows = (tmp_path / "out.csv").read_text().splitlines()
    if "--workdir" in flags:
        assert len(rows) == 3       # the header, the planted group's strands
        assert any((tmp_path / "tables").iterdir())
    else:                           # groups without a primer pair drop out
        assert 1 <= len(rows) <= 3


def test_no_krisp_tpu_import_in_port_sources():
    pattern = re.compile(r"^\s*(import|from)\s+krisp_tpu(\s|\.|$)")
    paths = [*(REPO / "krisp_tpu_torch").rglob("*.py"), REPO / "chip_smoke.py"]
    for path in paths:
        for line in path.read_text().splitlines():
            assert not pattern.match(line), (path, line)
