"""The port's run_pipeline and krisp_fasta CLI (device="cpu") vs krisp_tpu's
on synthetic genomes: rendered CSV and alignment bytes must be equal."""

import pytest

pytest.importorskip("jax")

import numpy as np  # noqa: E402

from krisp_tpu.cli.krisp_fasta import main as jax_main  # noqa: E402
from krisp_tpu.engine import pipeline as JP  # noqa: E402
from krisp_tpu.engine import render  # noqa: E402
from krisp_tpu_torch.cli.krisp_fasta import main as port_main  # noqa: E402
from krisp_tpu_torch.engine import pipeline as TP  # noqa: E402

N_FILES, IN_COUNT = 3, 2


def _genomes(tmp_path, seed, geom, alphabet="ACGTNacgt"):
    """Random records (with N and lowercase) plus planted regions: one
    shared by every genome, and one whose diagnostic bases differ between
    ingroup and outgroup, so the ingroup filter keeps it."""
    rng = np.random.default_rng(seed)
    left, mid, right = geom
    probs = [0.04] * (len(alphabet) - 4)
    p_main = (1 - sum(probs)) / 4
    shared = "".join(rng.choice(list("ACGT"), size=left + mid + right + 6))
    fl = "".join(rng.choice(list("ACGT"), size=left))
    fr = "".join(rng.choice(list("ACGT"), size=right))
    mid_in = "".join(rng.choice(list("AC"), size=mid))
    mid_out = mid_in.translate(str.maketrans("AC", "GT"))
    paths = []
    for f in range(N_FILES):
        seqs = ["".join(rng.choice(list(alphabet), size=rng.integers(30, 400),
                                   p=[p_main] * 4 + probs))
                for _ in range(4)]
        seqs.append(shared)
        seqs.append("GG" + fl + (mid_in if f < IN_COUNT else mid_out) + fr
                    + "CC")
        path = tmp_path / f"g{f}.fasta"
        path.write_text("".join(f">s{i}\n{s}\n" for i, s in enumerate(seqs)))
        paths.append(str(path))
    return paths


def _render(groups):
    csv = "".join(render.render_csv(g) + "\n" for g in groups)
    align = "".join(render.render_alignment(g) + "\n" for g in groups)
    return csv, align


@pytest.mark.parametrize("geom", [(25, 1, 2), (5, 0, 5), (4, 2, 3)])
@pytest.mark.parametrize("omit_soft", [False, True])
def test_run_pipeline_matches_jax(tmp_path, geom, omit_soft):
    paths = _genomes(tmp_path, sum(geom), geom)
    ins, outs = paths[:IN_COUNT], paths[IN_COUNT:]
    want = JP.run_pipeline(ins, outs, JP.KmerGeometry(*geom),
                           omit_soft=omit_soft)
    got = TP.run_pipeline(ins, outs, TP.KmerGeometry(*geom),
                          omit_soft=omit_soft, device="cpu")
    assert len(want) > 0
    assert _render(got) == _render(want)


@pytest.mark.parametrize("flags", [[], ["--dot-alignment", "--omit-soft"],
                                   ["--primer3"]])
def test_cli_matches_jax(tmp_path, monkeypatch, flags):
    monkeypatch.setenv("KRISP_TPU_CACHE", str(tmp_path / "jax_cache"))
    geom = (25, 1, 2)
    paths = _genomes(tmp_path, 7, geom)
    args = [*paths[:IN_COUNT], "--outgroup", *paths[IN_COUNT:],
            "--conserved-left", "25", "--conserved-right", "2",
            "--diagnostic", "1", *flags]
    outs = {}
    for name, main, extra in (("jax", jax_main, []),
                              ("port", port_main, ["--device", "cpu"])):
        csv, align = tmp_path / f"{name}.csv", tmp_path / f"{name}.txt"
        assert main(extra + args + ["--out_csv", str(csv),
                                    "--out_align", str(align)]) == 0
        outs[name] = (csv.read_bytes(), align.read_bytes())
    assert outs["port"] == outs["jax"]
    if not flags:
        assert outs["port"][0].count(b"\n") > 1   # header plus results


#: (geometry, alphabet, omit_soft): the wide-key prefilter (30/40/30),
#: a 4-word key whose 20-bit flank skips it (5/40/5), and IUPAC input,
#: which turns every key to 4 bits (25/1/2 takes the prefilter, 4/1/3 not)
WIDE_CASES = [((30, 40, 30), "ACGTNacgt", False),
              ((5, 40, 5), "ACGTNacgt", True),
              ((25, 1, 2), "ACGTRYNacgt", False),
              ((25, 1, 2), "ACGTRYNacgt", True),
              ((4, 1, 3), "ACGTRYN", False)]


@pytest.mark.parametrize("geom,alphabet,omit_soft", WIDE_CASES)
def test_run_pipeline_wide_and_iupac_match_jax(tmp_path, geom, alphabet,
                                               omit_soft):
    paths = _genomes(tmp_path, sum(geom), geom, alphabet=alphabet)
    ins, outs = paths[:IN_COUNT], paths[IN_COUNT:]
    want = JP.run_pipeline(ins, outs, JP.KmerGeometry(*geom),
                           omit_soft=omit_soft)
    got = TP.run_pipeline(ins, outs, TP.KmerGeometry(*geom),
                          omit_soft=omit_soft, device="cpu")
    assert len(want) > 0
    assert _render(got) == _render(want)


@pytest.mark.parametrize("case", ["amplicon", "amplicon_primer3",
                                  "iupac_dot"])
def test_cli_wide_and_iupac_match_jax(tmp_path, monkeypatch, case):
    """The README's amplicon example (--conserved 30 --amplicon 100, with
    and without --primer3) and an IUPAC spacer search (--dot-alignment)."""
    monkeypatch.setenv("KRISP_TPU_CACHE", str(tmp_path / "jax_cache"))
    if case.startswith("amplicon"):
        paths = _genomes(tmp_path, 100, (30, 40, 30))
        flags = ["--conserved", "30", "--amplicon", "100"]
        flags += ["--primer3"] if case == "amplicon_primer3" else []
    else:
        paths = _genomes(tmp_path, 28, (25, 1, 2), alphabet="ACGTRYNacgt")
        flags = ["--conserved-left", "25", "--conserved-right", "2",
                 "--diagnostic", "1", "--dot-alignment"]
    args = [*paths[:IN_COUNT], "--outgroup", *paths[IN_COUNT:], *flags]
    outs = {}
    for name, main, extra in (("jax", jax_main, []),
                              ("port", port_main, ["--device", "cpu"])):
        csv, align = tmp_path / f"{name}.csv", tmp_path / f"{name}.txt"
        assert main(extra + args + ["--out_csv", str(csv),
                                    "--out_align", str(align)]) == 0
        outs[name] = (csv.read_bytes(), align.read_bytes())
    assert outs["port"] == outs["jax"]
    if case != "amplicon_primer3":
        assert outs["port"][0].count(b"\n") > 1   # header plus results


def test_unported_branches_raise(tmp_path):
    """``workdir`` runs the staged path (its output equals krisp_tpu's);
    several devices and ``--profile-dir`` still raise."""
    geom = TP.KmerGeometry(4, 1, 3)
    paths = _genomes(tmp_path, 3, (4, 1, 3))
    got = TP.run_pipeline(paths[:1], paths[1:], geom, ingroup_filter=False,
                          workdir=str(tmp_path / "wd"), device="cpu")
    want = JP.run_pipeline(paths[:1], paths[1:], JP.KmerGeometry(4, 1, 3),
                           ingroup_filter=False)
    def snap(groups):
        return [(g.left, g.right, [(a.mid, a.label_counts)
                                   for a in g.amplicons]) for g in groups]
    assert len(want) > 0 and snap(got) == snap(want)
    assert len(list((tmp_path / "wd").glob("kmer_table_*.npz"))) == N_FILES
    with pytest.raises(NotImplementedError, match="device"):
        TP.run_pipeline(paths[:1], paths[1:], geom, n_devices=2,
                        device="cpu")
    with pytest.raises(NotImplementedError, match="profile-dir"):
        port_main(["--device", "cpu", *paths, "-c", "4", "-d", "1",
                   "--profile-dir", str(tmp_path)])
