"""The PyTorch port imports without JAX, CUDA or nvcc, and never falls back
to the CPU unless asked."""

import subprocess
import sys
from pathlib import Path

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
