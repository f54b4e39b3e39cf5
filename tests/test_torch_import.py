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
            "import krisp_tpu_torch.kstream, krisp_tpu_torch.kstream_device\n"
            "import krisp_tpu_torch.kstream_vec, krisp_tpu_torch.kstream_fast\n"
            "import krisp_tpu_torch.cli.kstream, krisp_tpu_torch.cli.tools\n"
            "import krisp_tpu_torch.cli.krisp_vcf, krisp_tpu_torch.ops.vcfclass\n"
            "import krisp_tpu_torch.vcf.fastscan, krisp_tpu_torch.vcf.report\n"
            "import krisp_tpu_torch.vcf.device_classify\n"
            "import krisp_tpu_torch.vcf.resume, krisp_tpu_torch.vcf.scan\n"
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


def test_kstream_cli_loads_no_krisp_tpu_module(tmp_path):
    """The port's kstream on the CPU, through the device engine, the host
    engine and the string pipeline, leaves no module of the JAX package
    loaded."""
    rng = np.random.default_rng(6)
    p = tmp_path / "g.fasta"
    p.write_text(">a\n" + "".join(rng.choice(list("ACGTN"), 3000,
                                             p=[.2475] * 4 + [.01]))
                 + "\n")
    base = [str(p), "-k", "28", "--canonicals", "--disallow", "Nn",
            "--sort", "--device", "cpu", "--output"]
    runs = [base + [str(tmp_path / f"{e}.txt"), "--engine", e]
            for e in ("device", "host")]
    runs.append([str(p), "-k", "5", "--device", "cpu", "--output",
                 str(tmp_path / "string.txt")])
    code = ("import sys\n"
            "from krisp_tpu_torch.cli.kstream import main\n"
            f"for argv in {runs!r}:\n"
            "    assert main(argv) == 0\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m == 'krisp_tpu' or m.startswith('krisp_tpu.'))\n"
            "assert not bad, bad\n"
            "assert 'jax' not in sys.modules\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
    device, host = ((tmp_path / f"{e}.txt").read_bytes()
                    for e in ("device", "host"))
    assert device == host and device.count(b"\n") > 1000
    assert (tmp_path / "string.txt").read_bytes().count(b"\n") == 2996


def test_kstream_device_engine_default_raises_without_cuda(tmp_path):
    """The device engine's default device is the card: without one it
    raises (k = 70 routes to it under ``auto``); the host engine needs no
    card."""
    from krisp_tpu_torch import kstream_device as kd
    from krisp_tpu_torch.cli.kstream import main
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = tmp_path / "g.fasta"
    p.write_text(">a\n" + "ACGTTGCA" * 40 + "\n")
    plan = kd.device_plan(kmers=70, disallow="Nn", sort=True)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        kd.run_device_kstream(str(p), plan, None)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        main([str(p), "-k", "70", "--disallow", "Nn", "--sort", "--output",
              str(tmp_path / "out.txt")])
    assert main([str(p), "-k", "28", "--disallow", "Nn", "--sort",
                 "--engine", "host", "--output",
                 str(tmp_path / "host.txt")]) == 0
    assert (tmp_path / "host.txt").read_bytes().count(b"\n") == 320 - 27


def test_vcf_cli_loads_no_krisp_tpu_module(tmp_path):
    """The port's krisp_vcf on the CPU, on the device engine (columnar fast
    scan and, for ``--vcf -``, the streaming route) and the host engine,
    leaves no module of the JAX package loaded."""
    from torch_vcf_inputs import synth_fuzz_diag_inputs
    # one contig: a stream's windows may not span contigs (krisp_tpu raises)
    meta, ref, vcf = synth_fuzz_diag_inputs(tmp_path, 2, contigs=("ctg1",))
    plain = tmp_path / "vars.vcf"
    import gzip
    plain.write_bytes(gzip.open(vcf).read())
    base = [meta, ref, "--groups", "EU1", "NA1", "--min_samples", "3",
            "--device", "cpu"]
    runs = [base + ["--vcf", vcf, "--engine", e, "--out_csv",
                    str(tmp_path / f"{e}.csv")] for e in ("device", "host")]
    code = ("import sys\n"
            "from krisp_tpu_torch.cli.krisp_vcf import main\n"
            f"for argv in {runs!r}:\n"
            "    assert main(argv) == 0\n"
            f"sys.stdin = open({str(plain)!r})\n"
            f"assert main({base!r} + ['--engine', 'device', '--out_csv', "
            f"{str(tmp_path / 'stdin.csv')!r}]) == 0\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m == 'krisp_tpu' or m.startswith('krisp_tpu.'))\n"
            "assert not bad, bad\n"
            "assert 'jax' not in sys.modules\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
    device, host, stdin = ((tmp_path / f"{e}.csv").read_bytes()
                           for e in ("device", "host", "stdin"))
    assert device == host == stdin and device.count(b"\n") > 1


def test_vcf_device_engine_default_raises_without_cuda(tmp_path):
    """krisp_vcf's ``--device`` defaults to the card: without one the
    device engine raises on both of its routes (the columnar fast scan
    and ``--vcf -``) and never classifies on the CPU; the host engine
    needs no card."""
    from krisp_tpu_torch.cli.krisp_vcf import main
    from torch_vcf_inputs import synth_fuzz_diag_inputs
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    meta, ref, vcf = synth_fuzz_diag_inputs(tmp_path, 2)
    base = [meta, ref, "--vcf", vcf, "--groups", "EU1", "NA1",
            "--out_csv", str(tmp_path / "out.csv")]
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        main(base + ["--engine", "device"])
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        main(base + ["--engine", "device", "--device", "cuda"])
    from krisp_tpu_torch.vcf.device_classify import classify_stream_device
    from krisp_tpu_torch.vcf.parser import VcfReader
    from krisp_tpu_torch.vcf.classify import parse_group_data
    groups = parse_group_data(meta, groups=["EU1", "NA1"])
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        next(classify_stream_device(VcfReader(vcf), groups))
    assert main(base + ["--engine", "host"]) == 0
    assert (tmp_path / "out.csv").read_bytes().count(b"\n") > 1


def test_vcf_dev_flag_is_devices():
    """``--dev 2`` is krisp_tpu's ``--devices 2``, never the port's
    ``--device``; ``--device`` is taken off before the copied parser."""
    from krisp_tpu.cli import krisp_vcf as jcli
    from krisp_tpu_torch.cli import krisp_vcf as tcli
    from krisp_tpu_torch.device import split_device_flag
    argv = ["meta.csv", "ref.fa", "--vcf", "v.vcf", "--dev", "2"]
    device, rest = split_device_flag(argv + ["--device", "cpu"])
    assert device == "cpu" and rest == argv
    assert vars(tcli.parse_args(rest)) == vars(jcli.parse_args(argv))
    assert tcli.parse_args(rest).devices == 2
    assert split_device_flag(argv)[0] == "cuda"
