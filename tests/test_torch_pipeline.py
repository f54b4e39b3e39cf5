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
    two devices asked for where one is present run on it, as krisp_tpu
    runs; ``--profile-dir`` writes a ``torch.profiler`` trace and the bytes
    of a run without it."""
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
    fused = TP.run_pipeline(paths[:1], paths[1:], geom, ingroup_filter=False,
                            device="cpu")
    assert snap(TP.run_pipeline(paths[:1], paths[1:], geom,
                                ingroup_filter=False, n_devices=2,
                                device="cpu")) == snap(fused) == snap(want)
    outs = []
    for flags in ([], ["--profile-dir", str(tmp_path / "prof")]):
        csv = tmp_path / f"out{len(flags)}.csv"
        assert port_main(["--device", "cpu", *paths, "-c", "4", "-d", "1",
                          "--out_csv", str(csv), *flags]) == 0
        outs.append(csv.read_bytes())
    assert outs[0] == outs[1] and outs[0].count(b"\n") > 1
    traces = list((tmp_path / "prof").glob("*.pt.trace.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0


def test_devices_clamped_to_those_present(tmp_path, monkeypatch):
    """krisp_tpu's device count: ``n_devices``, else KRISP_TPU_DEVICES, else
    all, never more than are present.  On the CPU (one device) a request
    for 2 or KRISP_TPU_DEVICES=4 runs, with the 1-device run's bytes."""
    geom = (25, 1, 2)
    paths = _genomes(tmp_path, 5, geom)
    ins, outs = paths[:IN_COUNT], paths[IN_COUNT:]
    one = _render(TP.run_pipeline(ins, outs, TP.KmerGeometry(*geom),
                                  n_devices=1, device="cpu"))
    assert one[0]
    assert _render(TP.run_pipeline(ins, outs, TP.KmerGeometry(*geom),
                                   n_devices=2, device="cpu")) == one
    monkeypatch.setenv("KRISP_TPU_DEVICES", "4")
    assert _render(TP.run_pipeline(ins, outs, TP.KmerGeometry(*geom),
                                   device="cpu")) == one


def test_devices_for_run_counts_as_krisp_tpu(monkeypatch):
    import torch
    from krisp_tpu_torch.device import devices_for_run
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    monkeypatch.delenv("KRISP_TPU_DEVICES", raising=False)
    assert devices_for_run(None, cuda) == 2       # all present
    assert devices_for_run(4, cuda) == 2          # clamped
    assert devices_for_run(0, cuda) == 1
    assert devices_for_run(4, cpu) == 1
    monkeypatch.setenv("KRISP_TPU_DEVICES", "1")
    assert devices_for_run(None, cuda) == 1
    assert devices_for_run(2, cuda) == 2          # the argument wins


def test_fused_path_over_several_devices_raises(tmp_path, monkeypatch):
    """Where two devices are present and asked for, the fused path is
    sharded over a mesh of two (here ``[cpu] * 2``, through ``make_mesh``)
    and renders the bytes of the one-device run; the staged path ignores
    the count and runs."""
    from krisp_tpu_torch.parallel import distributed
    paths = _genomes(tmp_path, 9, (25, 1, 2))
    geom = TP.KmerGeometry(25, 1, 2)
    one = _render(TP.run_pipeline(paths[:IN_COUNT], paths[IN_COUNT:], geom,
                                  n_devices=1, device="cpu"))
    assert one[0]
    meshes = []
    monkeypatch.setattr(TP, "devices_for_run", lambda n, dev: 2)
    monkeypatch.setattr(distributed, "make_mesh", lambda n: meshes.append(
        n) or distributed.Mesh(["cpu"] * n))
    assert _render(TP.run_pipeline(paths[:IN_COUNT], paths[IN_COUNT:], geom,
                                   device="cpu")) == one
    assert meshes == [2]
    assert TP.run_pipeline(paths[:IN_COUNT], paths[IN_COUNT:], geom,
                           workdir=str(tmp_path / "wd"), device="cpu")
    assert meshes == [2]


@pytest.mark.parametrize("flag", ["--devices", "--dev"])
def test_cli_devices_2_runs_on_one_device(tmp_path, flag):
    """``krisp_fasta --devices 2`` (or krisp_tpu's abbreviation ``--dev 2``,
    which the port's ``--device`` must not take) writes the 1-device
    run's bytes."""
    from krisp_tpu.cli.krisp_fasta import parse_args as jax_parse_args
    from krisp_tpu_torch.cli.krisp_fasta import parse_args
    from krisp_tpu_torch.device import split_device_flag
    paths = _genomes(tmp_path, 7, (25, 1, 2))
    args = [*paths[:IN_COUNT], "--outgroup", *paths[IN_COUNT:],
            "--conserved-left", "25", "--conserved-right", "2",
            "--diagnostic", "1"]
    device, rest = split_device_flag(["--device", "cpu", flag, "2", *args])
    assert device == "cpu"
    assert vars(parse_args(rest)) == vars(jax_parse_args(rest))
    assert parse_args(rest).devices == 2
    outs = []
    for extra in ([], [flag, "2"]):
        csv = tmp_path / f"out{len(extra)}.csv"
        assert port_main(["--device", "cpu", *extra, *args, "--out_csv",
                          str(csv)]) == 0
        outs.append(csv.read_bytes())
    assert outs[1] == outs[0] and outs[0].count(b"\n") > 1


def _two_bit_buffers(seed, sizes):
    """Genome buffers of the given sizes over A/C/G/T/N in both cases,
    mostly upper-case so that long windows stay valid under omit_soft."""
    rng = np.random.default_rng(seed)
    p = [0.245] * 4 + [0.02 / 6] * 6
    return [rng.choice(np.frombuffer(b"ACGTNacgtn", np.uint8), size=n, p=p)
            for n in sizes]


@pytest.mark.parametrize("geom", [(25, 1, 2), (30, 40, 30)])
@pytest.mark.parametrize("omit_soft", [False, True])
def test_fused_table_on_bytes_equals_host_pack(geom, omit_soft):
    """The fused table built from each genome's uploaded bytes equals the
    table built genome by genome from krisp_tpu's 2-bit host pack and its
    unpack (``_pack_genomes_host`` + ``extract_keys_packed_in``), zero
    padding of ``_stack`` included."""
    import torch

    from krisp_tpu_torch.convert import keys_from_numpy
    from krisp_tpu_torch.io.fasta import bucket_size
    from krisp_tpu_torch.ops import intersect as TI
    from krisp_tpu_torch.ops.encode import KeyLayout
    from krisp_tpu_torch.ops.pack import SENTINEL
    buffers = _two_bit_buffers(sum(geom), [700, 3001, 1500])
    assert TP.detect_bits(buffers) == 2
    n_files = len(buffers)
    layout = KeyLayout(*geom, 2, n_files)
    got = TP._fused_table(buffers, layout, TP.KmerGeometry(*geom), omit_soft,
                          torch.device("cpu"))
    stacked = TP._stack(buffers, bucket_size(max(b.size for b in buffers)))
    want = []
    for f in range(n_files):
        pk, vb = TP._pack_genomes_host(stacked[f:f + 1], omit_soft)
        want.append(TI.extract_keys_packed_in(
            keys_from_numpy(pk, "cpu"), torch.from_numpy(vb), f, *geom, 2,
            n_files))
    want = torch.cat(want, dim=1)
    assert got.shape == want.shape
    assert torch.equal(got, want)
    # the case holds valid windows, not only sentinel rows
    assert (got[0] != SENTINEL).any()


def test_fused_search_uploads_bytes_and_never_unpacks(tmp_path, monkeypatch):
    """A 2-bit fused search records one ``upload`` a genome of its padded
    bytes, no ``pack+upload``, and never unpacks a 2-bit pack."""
    from krisp_tpu_torch.io.fasta import bucket_size, load_buffer
    from krisp_tpu_torch.metrics import GLOBAL as METRICS
    from krisp_tpu_torch.ops import intersect as TI

    def unpack(*_):
        raise AssertionError("the fused path unpacked a 2-bit pack")
    monkeypatch.setattr(TI, "unpack_genomes", unpack)
    geom = (25, 1, 2)
    paths = _genomes(tmp_path, 5, geom)
    METRICS.reset()
    table, layout = TP.genome_key_tables(paths, TP.KmerGeometry(*geom),
                                         device="cpu")
    assert layout.bits == 2
    width = bucket_size(max(load_buffer(p).size for p in paths))
    st = METRICS.stages
    assert "pack+upload" not in st
    assert st["upload"].calls == len(paths)
    assert st["upload"].items == len(paths) * width
    assert st["extract"].calls == len(paths)
    assert table.shape[1] == len(paths) * 2 * (width - sum(geom) + 1)
