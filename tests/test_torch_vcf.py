"""The port's krisp_vcf slice against krisp_tpu's, on the CPU, on synthetic
VCFs (``tests/test_vcf_fuzz.py``'s and ``tests/test_vcf_multicontig.py``'s
recipes): the copied host modules (native tokenizer, parser, classify,
batch, region, scan, report, resume) give krisp_tpu's results; the fast
scan gives krisp_tpu's typed stream on every classification route; the
port's CLI with ``--device cpu`` writes krisp_tpu's CSV and alignment bytes
on the host, device and auto engines, on stdin, with ``--index``,
``--chroms``/``--pos``, ``--cores 2`` and ``--resume`` (each package
resuming the other's scan).  Tolerance 0 throughout."""

import gzip
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import krisp_tpu.vcf.report as jreport_mod  # noqa: E402
import krisp_tpu_torch.vcf.report as treport_mod  # noqa: E402
from krisp_tpu.cli import krisp_vcf as jcli  # noqa: E402
from krisp_tpu.io import native_vcf as jnat  # noqa: E402
from krisp_tpu.vcf import batch as jbatch  # noqa: E402
from krisp_tpu.vcf import classify as jclassify  # noqa: E402
from krisp_tpu.vcf import device_classify as jdc  # noqa: E402
from krisp_tpu.vcf import fastscan as jfast  # noqa: E402
from krisp_tpu.vcf import parser as jparser  # noqa: E402
from krisp_tpu.vcf import resume as jresume  # noqa: E402
from krisp_tpu.vcf import scan as jscan  # noqa: E402
from krisp_tpu_torch.cli import krisp_vcf as tcli  # noqa: E402
from krisp_tpu_torch.io import native_vcf as tnat  # noqa: E402
from krisp_tpu_torch.vcf import batch as tbatch  # noqa: E402
from krisp_tpu_torch.vcf import classify as tclassify  # noqa: E402
from krisp_tpu_torch.vcf import device_classify as tdc  # noqa: E402
from krisp_tpu_torch.vcf import fastscan as tfast  # noqa: E402
from krisp_tpu_torch.vcf import parser as tparser  # noqa: E402
from krisp_tpu_torch.vcf import resume as tresume  # noqa: E402
from krisp_tpu_torch.vcf import scan as tscan  # noqa: E402

from test_vcf_fuzz import synth_dense_inputs, synth_fuzz_inputs  # noqa: E402
from test_vcf_multicontig import synth_inputs as synth_multicontig  # noqa
from torch_vcf_inputs import synth_fuzz_diag_inputs  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
# the reference's bundled VCF and the goldens, as the JAX package's golden
# tests name them
from test_golden_vcf import GOLD, META, REF_FASTA, VCF  # noqa: E402

SCAN_KW = dict(min_samples=3, min_samp_prop=0.9, min_reads=10,
               min_geno_qual=40, min_var_qual=10, min_freq=0.1,
               min_map_qual=40, min_bases=1, crrna_len=28,
               var_location=(6, 14), amp_size=(70, 150))
CLASSIFY_KW = {k: SCAN_KW[k] for k in ("min_samples", "min_samp_prop",
                                       "min_reads", "min_geno_qual",
                                       "min_var_qual", "min_freq",
                                       "min_map_qual")}


INPUTS = {
    "fuzz": (lambda d: synth_fuzz_inputs(d, 13), ["EU1", "NA1"]),
    "fuzz_diag": (lambda d: synth_fuzz_diag_inputs(d, 1), ["EU1", "NA1"]),
    "multicontig": (synth_multicontig, ["EU1", "NA1", "NA2"]),
}


@pytest.fixture(scope="module", params=sorted(INPUTS))
def vcf_input(request, tmp_path_factory):
    make, groups = INPUTS[request.param]
    d = tmp_path_factory.mktemp(request.param)
    meta, ref, vcf = make(d)
    return request.param, meta, ref, vcf, groups


def _digest(r):
    """A typed window as the report layer sees it (``test_fastscan``)."""
    if r.type == "Diagnostic":
        return (r.type, r.group, tuple(r.crrna_range), tuple(r.temp_range),
                "".join(r.crrna_seq), r.min_bases)
    return (r.type,)


def _columnar_fields(col):
    return dict(samples=col.samples, chroms=col.chroms,
                chrom_id=col.chrom_id, pos=col.pos, qual=col.qual, mq=col.mq,
                n_alleles=col.n_alleles, dp=col.dp, gq=col.gq, ad=col.ad,
                rlen=col.rlen, alen=col.alen, alleles=list(col.alleles))


def _assert_fields_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


def _variant_fields(v):
    return (v.chrom, v.pos, v.id, v.ref, tuple(v.alts), v.qual, v.mq,
            tuple((s, d.dp, d.gq, tuple(d.ad)) for s, d in v.samples.items()))


def _classified_fields(c):
    return (c.sample_counts, c.allele_counts, c.conserved, c.diagnostic)


def test_native_tokenizer_equal(vcf_input, tmp_path):
    """The port's own build of ``vcfio.cpp`` (``io/_native``) reads the
    columns, the index and the window replay as krisp_tpu's does."""
    _, _, _, vcf, _ = vcf_input
    assert tnat.get_lib() is not None
    assert Path(tnat._LIB).parent == REPO / "krisp_tpu_torch" / "io" / \
        "_native"
    _assert_fields_equal(_columnar_fields(tnat.read_columnar(vcf, 4)),
                         _columnar_fields(jnat.read_columnar(vcf, 4)))
    ti = tnat.read_index(vcf, tmp_path / "t.vcf")
    ji = jnat.read_index(vcf, tmp_path / "j.vcf")
    _assert_fields_equal(ti, ji)
    assert (tmp_path / "t.vcf").read_bytes() == (tmp_path / "j.vcf") \
        .read_bytes()


def test_window_types_native_equal():
    rng = np.random.default_rng(3)
    for trial in range(10):
        V = 300
        pos = np.cumsum(rng.integers(0, 12, V)) + 1
        starts = pos - 1
        ends = starts + rng.choice([1, 1, 1, 2, 5, 30], V) - 1
        delta = rng.choice([-3, 0, 0, 0, 1, 4], V)
        is_diag = rng.random(V) < 0.2
        is_consv = rng.random(V) < 0.8
        span, min_vars = int(rng.choice([5, 9, 20])), int(rng.integers(1, 3))
        got = tnat.window_types_native(starts, ends, delta, is_diag,
                                       is_consv, span, min_vars)
        want = jnat.window_types_native(starts, ends, delta, is_diag,
                                        is_consv, span, min_vars)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        oracle = tfast._window_types(starts.tolist(), ends.tolist(),
                                     delta.tolist(), is_diag.tolist(),
                                     is_consv.tolist(), span, min_vars)
        np.testing.assert_array_equal(got[0], np.asarray(oracle[0], np.int8))
        np.testing.assert_array_equal(got[1], np.asarray(oracle[1]))


def test_parser_and_index_equal(vcf_input):
    """``VcfReader`` records, ``VcfOffsetIndex`` contigs, counts, fetches
    and per-contig columnar slices."""
    _, _, _, vcf, _ = vcf_input
    tv = [_variant_fields(v) for v in tparser.VcfReader(vcf)]
    jv = [_variant_fields(v) for v in jparser.VcfReader(vcf)]
    assert tv == jv and len(tv) > 50
    ti, ji = tparser.VcfOffsetIndex(vcf), jparser.VcfOffsetIndex(vcf)
    try:
        assert ti.contigs == ji.contigs and ti.n_records() == ji.n_records()
        for contig, _ in ti.contigs:
            for lo, hi in ((None, None), (500, 2500), (3000, None)):
                assert ti.n_records_in(contig, lo, hi) == \
                    ji.n_records_in(contig, lo, hi)
                assert [_variant_fields(v) for v in ti.fetch(contig, lo, hi)] \
                    == [_variant_fields(v) for v in ji.fetch(contig, lo, hi)]
            _assert_fields_equal(_columnar_fields(ti.columnar_slice(contig)),
                                 _columnar_fields(ji.columnar_slice(contig)))
        assert ti.native_ok() == ji.native_ok()
    finally:
        ti.cleanup()
        ji.cleanup()


def test_classify_and_batch_equal(vcf_input):
    """``parse_group_data``, ``ClassifiedVariant`` on every record and
    ``build_batch``'s arrays."""
    _, meta, _, vcf, groups = vcf_input
    tg = tclassify.parse_group_data(meta, groups=groups, min_samples=3)
    jg = jclassify.parse_group_data(meta, groups=groups, min_samples=3)
    assert tg == jg
    variants = list(tparser.VcfReader(vcf))
    jvariants = list(jparser.VcfReader(vcf))
    for kw in (CLASSIFY_KW, dict(CLASSIFY_KW, min_reads=0, min_freq=0.3)):
        got = [_classified_fields(tclassify.ClassifiedVariant(v, tg, **kw))
               for v in variants]
        want = [_classified_fields(jclassify.ClassifiedVariant(v, jg, **kw))
                for v in jvariants]
        assert got == want
    ta, tn, ts = tbatch.build_batch(variants, tg)
    ja, jn, js = jbatch.build_batch(jvariants, jg)
    assert (tn, ts) == (jn, js)
    _assert_fields_equal(ta, ja)


def test_host_scan_equal(vcf_input):
    """``scan.find_diag_region`` (region windows, the cascade and primer
    design on the port's ``thermo``): the same typed stream."""
    _, meta, ref, vcf, groups = vcf_input
    g = tclassify.parse_group_data(meta, groups=groups, min_samples=3)
    reference = tcli.parse_reference(ref)
    assert reference == jcli.parse_reference(ref)
    n = 0
    for contig in reference:    # windows never span contigs
        got = [_digest(r) for r in tscan.find_diag_region(
            tparser.VcfReader(vcf).fetch(contig), g, reference, **SCAN_KW)]
        want = [_digest(r) for r in jscan.find_diag_region(
            jparser.VcfReader(vcf).fetch(contig), g, reference, **SCAN_KW)]
        assert got == want
        n += len(got)
    assert n > 50


@pytest.mark.parametrize("protocol", ["numpy", "small", "full"])
def test_fast_scan_typed_stream_equal(vcf_input, protocol):
    """``find_diag_region_fast`` on the CPU gives krisp_tpu's typed stream
    (and the host scan's) on each classification route: the numpy mirror
    the CPU takes, and the small-pull and full packed protocols of a card,
    run here in torch ops on the CPU."""
    _, meta, ref, vcf, groups = vcf_input
    g = tclassify.parse_group_data(meta, groups=groups, min_samples=3)
    reference = tcli.parse_reference(ref)
    ti, ji = tparser.VcfOffsetIndex(vcf), jparser.VcfOffsetIndex(vcf)
    try:
        for contig, _ in ti.contigs:
            tcol, jcol = ti.columnar_slice(contig), ji.columnar_slice(contig)
            chunk = {"contig": contig, "start": 0, "end": 7000}
            rows = tfast.chunk_rows(tcol, chunk)
            np.testing.assert_array_equal(rows, jfast.chunk_rows(jcol, chunk))
            with mock.patch.object(tfast, "_protocol",
                                   return_value=protocol):
                got = [_digest(r) for r in tfast.find_diag_region_fast(
                    tcol, rows, g, reference, device="cpu", **SCAN_KW)]
            want = [_digest(r) for r in jfast.find_diag_region_fast(
                jcol, rows, g, reference, **SCAN_KW)]
            host = [_digest(r) for r in jscan.find_diag_region(
                ji.fetch(contig, 0, 7000), g, reference, **SCAN_KW)]
            assert got == want == host and len(got) > 0
    finally:
        ti.cleanup()
        ji.cleanup()


@pytest.fixture(scope="module")
def big_columnar(tmp_path_factory):
    """One contig of about 4,900 fuzz-style records, as both packages
    read it."""
    d = tmp_path_factory.mktemp("big")
    meta, _, vcf = synth_fuzz_diag_inputs(d, 3, contigs=("ctg1",),
                                          contig_len=280_000)
    g = tclassify.parse_group_data(meta, groups=["EU1", "NA1"])
    ti, ji = tparser.VcfOffsetIndex(vcf), jparser.VcfOffsetIndex(vcf)
    yield g, ti.columnar(), ji.columnar()
    ti.cleanup()
    ji.cleanup()


@pytest.mark.parametrize("n_rows", [1, 280, 300, 4097])
@pytest.mark.parametrize("protocol", ["numpy", "small", "full"])
def test_classify_columnar_no_padding_rows(big_columnar, protocol, n_rows):
    """The port does not pad batches (krisp_tpu pads to power-of-two
    buckets for XLA's compile cache): every route gives krisp_tpu's padded
    results row for row, at row counts off and on the bucket edges and
    across a batch boundary."""
    g, tcol, jcol = big_columnar
    names = list(g)
    assert tcol.n_records >= n_rows
    rows = np.arange(n_rows, dtype=np.int64)
    with mock.patch.object(tfast, "_protocol", return_value=protocol):
        got = tfast._classify_columnar(tcol, rows, names, g, CLASSIFY_KW,
                                       device="cpu")
    # krisp_tpu's accelerator path (small pull, padded buckets) and its
    # CPU path (the numpy mirror, padded too)
    with mock.patch("jax.default_backend", return_value="tpu"):
        small = jfast._classify_columnar(jcol, rows, names, g, CLASSIFY_KW)
    with mock.patch("jax.default_backend", return_value="cpu"):
        full = jfast._classify_columnar(jcol, rows, names, g, CLASSIFY_KW)
    want = small if protocol == "small" else full
    for k, (a, b) in enumerate(zip(got, want)):
        if b is None:
            assert a is None, k
        else:
            assert a.dtype == b.dtype and a.shape[0] == n_rows, k
            np.testing.assert_array_equal(a, b, err_msg=str(k))
    np.testing.assert_array_equal(got[4], full[4])


def test_protocol_routing():
    """A card takes the small pull where A <= 15 and S <= 32767, else the
    full layout; the CPU takes the numpy mirror (``fastscan.py:189-199``)."""
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    assert tfast._protocol(cpu, 2, 100) == "numpy"
    assert tfast._protocol(cuda, 15, 32767) == "small"
    assert tfast._protocol(cuda, 16, 100) == "full"
    assert tfast._protocol(cuda, 8, 32768) == "full"


def test_stream_device_route_equal(vcf_input):
    """``classify_stream_device`` (the ``--vcf -`` route): the port's torch
    ``classify_batch`` on the CPU, in batches of 64, gives krisp_tpu's
    classified variants."""
    _, meta, _, vcf, groups = vcf_input
    g = tclassify.parse_group_data(meta, groups=groups, min_samples=3)
    got = [_classified_fields(v) for v in tdc.classify_stream_device(
        tparser.VcfReader(vcf), g, batch_size=64, device="cpu",
        **CLASSIFY_KW)]
    want = [_classified_fields(v) for v in jdc.classify_stream_device(
        jparser.VcfReader(vcf), g, batch_size=64, **CLASSIFY_KW)]
    host = [_classified_fields(v) for v in jclassify.ClassifiedVariant
            .from_vcf(jparser.VcfReader(vcf), g, **CLASSIFY_KW)]
    assert got == want == host
    with pytest.raises(ValueError):
        next(tdc.classify_stream_device(tparser.VcfReader(vcf), g,
                                        device="cpu", min_reads=0))


@pytest.mark.parametrize("engine", ["host", "device"])
def test_report_batches_equal(vcf_input, engine):
    """``report.report_diag_region``'s result/stats batches (the printer's
    CSV and alignment text included) over the whole index."""
    _, meta, ref, vcf, groups = vcf_input
    g = tclassify.parse_group_data(meta, groups=groups, min_samples=3)
    reference = tcli.parse_reference(ref)
    ti, ji = tparser.VcfOffsetIndex(vcf), jparser.VcfOffsetIndex(vcf)
    try:
        assert treport_mod.resolve_engine(ti, {"engine": "auto"}) == \
            jreport_mod.resolve_engine(ji, {"engine": "auto"}) == "host"
        assert treport_mod.uses_device_fast_path(ti, {"engine": engine}) == \
            jreport_mod.uses_device_fast_path(ji, {"engine": engine})
        kw = dict(SCAN_KW, engine=engine)
        got = [(b["result"], dict(b["stats"]), b["alignment"])
               for b in treport_mod.report_diag_region(
                   ti, None, g, reference, True, device="cpu", **kw)]
        want = [(b["result"], dict(b["stats"]), b["alignment"])
                for b in jreport_mod.report_diag_region(
                    ji, None, g, reference, True, **kw)]
        assert got == want
    finally:
        ti.cleanup()
        ji.cleanup()
    assert treport_mod.AUTO_DEVICE_MIN_RECORDS == \
        jreport_mod.AUTO_DEVICE_MIN_RECORDS == 50_000


def _run_main(main, argv):
    assert main(argv) in (0, None)


def _outputs(d, tag):
    return ((d / f"{tag}.csv").read_bytes(),
            (d / f"{tag}.align.txt").read_bytes())


def _cli_pair(tmp_path, meta, ref, vcf, groups, flags, port_flags=()):
    """krisp_tpu's CLI and the port's (``--device cpu``) in this process
    (the same hash seed, so the missing-sample sets join alike): their
    (csv, alignment) bytes."""
    outs = []
    for tag, main, extra in (("jax", jcli.main, []),
                             ("port", tcli.main, ["--device", "cpu",
                                                  *port_flags])):
        _run_main(main, [meta, ref, "--vcf", vcf, "--groups", *groups,
                         *flags, *extra,
                         "--out_csv", str(tmp_path / f"{tag}.csv"),
                         "--out_align", str(tmp_path / f"{tag}.align.txt")])
        outs.append(_outputs(tmp_path, tag))
    return outs


CLI_CASES = {
    "fuzz_diag": (synth_fuzz_diag_inputs, 1, ["EU1", "NA1"]),
    "dense": (synth_dense_inputs, 701, ["EU1", "NA1"]),
    "multicontig": (None, None, ["EU1", "NA1", "NA2"]),
}


def _make(case, d):
    make, seed, groups = CLI_CASES[case]
    return (*(synth_multicontig(d) if make is None else make(d, seed)),
            groups)


@pytest.mark.parametrize("case,engine", [
    (case, engine) for case in sorted(CLI_CASES)
    for engine in ("host", "device", "auto")
    # dense: overlapping indels, the alignment's fallback text (auto takes
    # the host engine on these small files)
    if (case, engine) != ("dense", "auto")])
def test_cli_bytes_equal(tmp_path, case, engine):
    meta, ref, vcf, groups = _make(case, tmp_path)
    jax_, port = _cli_pair(tmp_path, meta, ref, vcf, groups,
                           ["--min_samples", "3", "--engine", engine])
    assert port == jax_
    assert port[0].count(b"\n") > 1      # the header and result rows


@pytest.mark.parametrize("engine", ["host", "device"])
def test_cli_stdin_equal(tmp_path, engine):
    """``--vcf -``: the VCF on standard input (the device engine's
    streaming route, ``classify_stream_device``)."""
    meta, ref, vcf, groups = _make("fuzz_diag", tmp_path)
    with gzip.open(vcf, "rb") as fh:
        text = fh.read()
    outs = []
    for tag, module, extra in (
            ("jax", "krisp_tpu.cli.krisp_vcf", []),
            ("port", "krisp_tpu_torch.cli.krisp_vcf", ["--device", "cpu"])):
        proc = subprocess.run(
            [sys.executable, "-m", module, meta, ref, "--groups", *groups,
             "--min_samples", "3", "--engine", engine, *extra,
             "--out_csv", str(tmp_path / f"{tag}.csv"),
             "--out_align", str(tmp_path / f"{tag}.align.txt")],
            input=text, capture_output=True, timeout=300, cwd=REPO,
            env={"PYTHONHASHSEED": "0", "PYTHONPATH": str(REPO),
                 "PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"})
        assert proc.returncode == 0, proc.stderr[-2000:].decode()
        outs.append(_outputs(tmp_path, tag))
    assert outs[0] == outs[1] and outs[0][0].count(b"\n") > 1


def test_cli_index_chroms_pos_equal(tmp_path):
    """``--index`` (sidecar written, then reused), ``--chroms`` and
    ``--pos`` slices."""
    meta, ref, vcf, groups = _make("fuzz_diag", tmp_path)
    side = tmp_path / "side.idx"
    base = ["--min_samples", "3", "--engine", "device"]
    first = _cli_pair(tmp_path, meta, ref, vcf, groups, base,
                      ["--index", str(side)])
    assert side.exists()
    again = _cli_pair(tmp_path, meta, ref, vcf, groups, base,
                      ["--index", str(side)])
    assert first[0] == first[1] == again[1]
    for flags in (["--chroms", "ctg2"], ["--pos", "1500", "6000"],
                  ["--chroms", "ctg1", "--pos", "2000", "8000"]):
        jax_, port = _cli_pair(tmp_path, meta, ref, vcf, groups,
                               base + flags)
        assert port == jax_, flags
    assert b"ctg2" in first[0][0] and b"ctg1" in first[0][0]


def test_cli_host_engine_cores_2(tmp_path):
    """``--cores 2`` on the host engine (the spawn worker pool, one chunk a
    worker): the rows of krisp_tpu's serial run, in arrival order."""
    meta, ref, vcf, groups = _make("fuzz_diag", tmp_path)
    (jcsv, _), _ = _cli_pair(tmp_path, meta, ref, vcf, groups,
                             ["--min_samples", "3", "--engine", "host"])
    _run_main(tcli.main, [meta, ref, "--vcf", vcf, "--groups", *groups,
                          "--min_samples", "3", "--engine", "host",
                          "--cores", "2", "--device", "cpu",
                          "--out_csv", str(tmp_path / "par.csv")])
    want = jcsv.decode().splitlines()
    got = (tmp_path / "par.csv").read_text().splitlines()
    assert got[0] == want[0] and sorted(got[1:]) == sorted(want[1:])
    assert len(want) > 2


class _Boom(RuntimeError):
    pass


@pytest.mark.parametrize("engine", ["host", "device"])
@pytest.mark.parametrize("crash_in", ["port", "jax"])
def test_resume_across_packages(tmp_path, monkeypatch, crash_in, engine):
    """A scan stopped in its second chunk by one package is resumed by the
    other: the progress file's fingerprint is the same in both, and the
    resumed files equal an uninterrupted run's bytes."""
    meta, ref, vcf, groups = _make("multicontig", tmp_path)
    flags = [meta, ref, "--vcf", vcf, "--groups", *groups, "--engine",
             engine]
    full = [str(tmp_path / "full.csv"), str(tmp_path / "full.align")]
    jcli.run_all(jcli.parse_args(flags + ["--out_csv", full[0],
                                          "--out_align", full[1]]))
    out = [str(tmp_path / "res.csv"), str(tmp_path / "res.align")]
    argv = flags + ["--out_csv", out[0], "--out_align", out[1], "--resume"]

    crash_mod = treport_mod if crash_in == "port" else jreport_mod
    real = crash_mod.report_diag_region
    calls = {"n": 0}

    def flaky(*a, **kw):
        calls["n"] += 1
        for i, item in enumerate(real(*a, **kw)):
            if calls["n"] == 2 and i == 1:
                raise _Boom("stopped in the second chunk")
            yield item

    monkeypatch.setattr(crash_mod, "report_diag_region", flaky)
    with pytest.raises(_Boom):
        if crash_in == "port":
            tcli.run_all(tcli.parse_args(argv), "cpu")
        else:
            jcli.run_all(jcli.parse_args(argv))
    monkeypatch.setattr(crash_mod, "report_diag_region", real)
    progress = Path(out[0] + ".progress")
    assert progress.exists() and calls["n"] == 2
    assert tresume._fingerprint(tcli.parse_args(argv), [1, 2]) == \
        jresume._fingerprint(jcli.parse_args(argv), [1, 2])
    if crash_in == "port":
        jcli.run_all(jcli.parse_args(argv))
    else:
        tcli.run_all(tcli.parse_args(argv), "cpu")
    assert Path(out[0]).read_bytes() == Path(full[0]).read_bytes()
    assert Path(out[1]).read_bytes() == Path(full[1]).read_bytes()
    assert not progress.exists()


GOLDENS = {
    "full": [],
    "pos150k_260k": ["--pos", "150000", "260000"],
    "chroms_260k_400k": ["--chroms", "Phyram_PR-102_s0001", "--pos",
                         "260000", "400000"],
    "custom_knobs": ["--pos", "150000", "260000", "--amp_size", "50", "120",
                     "--gc_clamp", "2", "--min_samples", "4", "--crrna_len",
                     "30", "--var_location", "5", "16"],
}


@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_port_cli_golden(tmp_path, name):
    """The port's CLI against ``tests/golden/vcf_*`` on the reference's
    bundled VCF, where that data is mounted."""
    if not Path(VCF).exists():
        pytest.skip(f"{VCF} is absent")
    csv, align = tmp_path / "out.csv", tmp_path / "out.align.txt"
    proc = subprocess.run(
        [sys.executable, "-m", "krisp_tpu_torch.cli.krisp_vcf", META,
         REF_FASTA, "--vcf", VCF, "--groups", "NA1",
         "NA2", "EU1", "--device", "cpu", *GOLDENS[name],
         "--out_csv", str(csv), "--out_align", str(align)],
        capture_output=True, text=True, timeout=900, cwd=REPO,
        env={"PYTHONHASHSEED": "0", "PYTHONPATH": str(REPO),
             "PATH": "/usr/bin:/bin", "COLUMNS": "80"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert csv.read_text() == (GOLD / f"vcf_{name}.csv").read_text()
    assert align.read_text() == (GOLD / f"vcf_{name}.align.txt").read_text()
