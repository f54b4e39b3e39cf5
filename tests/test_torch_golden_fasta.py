"""Byte-for-byte golden parity of the port's krisp_fasta CLI on the
reference's bundled test data (``tests/golden/*``, the outputs
``tests/test_golden_fasta.py`` holds krisp_tpu to), with ``--device cpu``
and the arguments that test uses.  Skips where the data is absent."""

import glob
from pathlib import Path

import pytest

from krisp_tpu_torch.cli.krisp_fasta import main as krisp_fasta_main

DATA = "/root/reference/test_data/krisp_fasta"
GOLD = Path(__file__).parent / "golden"
INGROUP = sorted(glob.glob(f"{DATA}/ingroup*.fasta.gz"))
OUTGROUP = sorted(glob.glob(f"{DATA}/outgroup*.fasta.gz"))
SPACER = ["--conserved-left", "25", "--conserved-right", "2",
          "--diagnostic", "1"]

#: golden name -> (arguments, whether its CSV is held too)
CASES = {
    "spacer_25_1_2": (INGROUP + ["--outgroup"] + OUTGROUP + SPACER, True),
    "spacer_25_1_2_dot": (INGROUP + ["--outgroup"] + OUTGROUP + SPACER
                          + ["--dot-alignment"], False),
    "conserved_60": (INGROUP + OUTGROUP + ["--conserved", "30",
                                           "--diagnostic", "0"], True),
    "amplicon_100": (INGROUP + ["--outgroup"] + OUTGROUP
                     + ["--conserved", "30", "--amplicon", "100"], True),
}


@pytest.mark.parametrize("route", ["fused", "staged"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_port_cli_golden(tmp_path, monkeypatch, name, route):
    """Both routes write the golden bytes: the default budget's (fused at
    this size) and a one-byte budget's (staged)."""
    if not Path(DATA).exists():
        pytest.skip(f"{DATA} is absent")
    if route == "staged":
        monkeypatch.setenv("KRISP_TPU_HBM_BUDGET", "1")
    else:
        monkeypatch.delenv("KRISP_TPU_HBM_BUDGET", raising=False)
    args, with_csv = CASES[name]
    csv, align = tmp_path / "out.csv", tmp_path / "out.align.txt"
    krisp_fasta_main(args + ["--device", "cpu", "--out_csv", str(csv),
                             "--out_align", str(align)])
    if with_csv:
        assert csv.read_text() == (GOLD / f"{name}.csv").read_text()
    assert align.read_text() == (GOLD / f"{name}.align.txt").read_text()
