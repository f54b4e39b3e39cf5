"""The port's own copies of krisp_tpu's host modules give krisp_tpu's
results on the same inputs: ``dna``, ``engine.groups``/``render``,
``engine.checkpoint``, ``io.fasta``/``native``, the CLI's ``parse_args``,
the primer design and kstream's host engines (native core and numpy).  Outputs are strings, bytes and integers: the
tolerance is 0 (the primer scores are floats computed by the same code in
the same order, so they are equal too)."""

import bz2
import gzip
import io
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("jax")

from krisp_tpu import dna as jdna  # noqa: E402
from krisp_tpu import kstream_device as jkd  # noqa: E402
from krisp_tpu import kstream_vec as jvec  # noqa: E402
from krisp_tpu.cli import krisp_fasta as jcli  # noqa: E402
from krisp_tpu.engine import checkpoint as jckpt  # noqa: E402
from krisp_tpu.engine import groups as jgroups  # noqa: E402
from krisp_tpu.engine import render as jrender  # noqa: E402
from krisp_tpu.io import fasta as jfasta  # noqa: E402
from krisp_tpu.thermo import design as jdesign  # noqa: E402
from krisp_tpu_torch import dna as tdna  # noqa: E402
from krisp_tpu_torch import kstream_device as tkd  # noqa: E402
from krisp_tpu_torch import kstream_vec as tvec  # noqa: E402
from krisp_tpu_torch.cli import krisp_fasta as tcli  # noqa: E402
from krisp_tpu_torch.engine import checkpoint as tckpt  # noqa: E402
from krisp_tpu_torch.engine import groups as tgroups  # noqa: E402
from krisp_tpu_torch.engine import render as trender  # noqa: E402
from krisp_tpu_torch.io import fasta as tfasta  # noqa: E402
from krisp_tpu_torch.io import native as tnative  # noqa: E402
from krisp_tpu_torch.thermo import chain as tchain  # noqa: E402
from krisp_tpu_torch.thermo import design as tdesign  # noqa: E402


def test_dna_helpers_match():
    rng = np.random.default_rng(3)
    for name in ("CODE2_TABLE", "CODE4_TABLE", "COMP2_TABLE", "COMP4_TABLE"):
        np.testing.assert_array_equal(getattr(tdna, name),
                                      getattr(jdna, name))
    for bits in (2, 4):
        for disallow in ("", "Nn"):
            for omit in (False, True):
                np.testing.assert_array_equal(
                    tdna.base_validity_table(bits, disallow, omit),
                    jdna.base_validity_table(bits, disallow, omit))
    for alphabet in (b"ACGT", b"ACGTNacgtn", b"ACGTRYKM"):
        data = rng.choice(np.frombuffer(alphabet, np.uint8), 500)
        assert tdna.choose_bits(data) == jdna.choose_bits(data)
    words = rng.integers(0, 2**32, (40, 3), dtype=np.uint64).astype(
        np.uint32)
    for bits, offsets in ((2, [0, 2, 10, 40]), (4, [0, 4, 8, 60])):
        assert tdna.decode_bits(words, offsets, bits) == \
            jdna.decode_bits(words, offsets, bits)
    np.testing.assert_array_equal(tdna.extract_bit_field(words, 45, 4),
                                  jdna.extract_bit_field(words, 45, 4))
    assert tdna.decode_words(words, 20, 2) == jdna.decode_words(words, 20, 2)
    seqs = ["ACGTAC", "ACGAAC", "TCGTAC"]
    assert tdna.collapse_to_iupac(seqs) == jdna.collapse_to_iupac(seqs)
    assert tdna.revcomp("ACGTRYN") == jdna.revcomp("ACGTRYN")


def _groups(pkg, specs, ingroup):
    out = []
    for left, right, mids in specs:
        g = pkg.FlankGroup(left=left, right=right, ingroup=ingroup)
        for mid, labels in mids:
            g.add(pkg.KmerAmplicon(left=left, mid=mid, right=right,
                                   label_counts=dict(labels)))
        out.append(g)
    return out


_SPECS = [
    ("ACGTACGTAC", "GG", [("A", {"g0": 1, "g1": 2}), ("C", {"g2": 1})]),
    ("TTTTACGTAA", "CA", [("GT", {"g0": 1}), ("GA", {"g1": 1}),
                          ("CA", {"g2": 3})]),
    ("GGGCCCAAAT", "TT", [("T", {"g0": 1, "g1": 1}),
                          ("G", {"g1": 1, "g2": 1})]),
]


@pytest.mark.parametrize("dot", [False, True])
@pytest.mark.parametrize("ingroup", [None, frozenset({"g0", "g1"})])
def test_render_bytes_match(dot, ingroup):
    tg, jg = (_groups(tgroups, _SPECS, ingroup),
              _groups(jgroups, _SPECS, ingroup))
    assert trender.csv_header() == jrender.csv_header()
    assert trender.csv_header(primer3=True) == jrender.csv_header(True)
    for a, b in zip(tg, jg):
        assert trender.render_csv(a) == jrender.render_csv(b)
        assert trender.render_alignment(a, enable_dot=dot) == \
            jrender.render_alignment(b, enable_dot=dot)
        assert a.ingroup_unique_columns() == b.ingroup_unique_columns()
        if ingroup:
            assert a.ingroup_consensus() == b.ingroup_consensus()


def _amplicon_groups(pkg, seed, n):
    """Groups of 100-base amplicons (30 + 40 + 30), random bases at about
    50% GC, whose middles differ between the ingroup and the outgroup."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        fl, fr = ("".join(rng.choice(list("ACGT"), 30)) for _ in range(2))
        mid_in = "".join(rng.choice(list("ACGT"), 40))
        mid_out = mid_in.translate(str.maketrans("ACGT", "CATG"))
        out.append(_groups(pkg, [(fl, fr, [(mid_in, {"g0": 1, "g1": 1}),
                                           (mid_out, {"g2": 1})])],
                           frozenset({"g0", "g1"}))[0])
    return out


@pytest.mark.parametrize("args,pairs", [
    (dict(tm=(53, 68), gc=(40, 70), amp_size=(70, 150), primer_size=(25, 35),
          max_sec_tm=40, gc_clamp=1, max_end_gc=4), 0),     # the CLI's
    (dict(tm=(53, 68), gc=(40, 70), amp_size=(70, 150),
          primer_size=(20, 30)), 1),
    (dict(tm=(50, 70), gc=(30, 80), amp_size=(60, 150),
          primer_size=(18, 27)), 3)])
def test_primer_design_matches(args, pairs):
    tg, jg = _amplicon_groups(tgroups, 5, 4), _amplicon_groups(jgroups, 5, 4)
    found = 0
    for a, b in zip(tg, jg):
        tdesign.design_primers_for_group(a, **args)
        jdesign.design_primers_for_group(b, **args)
        assert a.p3 == b.p3
        if a.p3["PRIMER_PAIR_NUM_RETURNED"]:    # the CLI renders only these
            found += 1
            assert trender.render_csv(a) == jrender.render_csv(b)
            assert trender.render_alignment(a) == jrender.render_alignment(b)
    assert found == pairs
    # the port's structure DP is its own build of its own source
    lib = tchain.get_lib()
    assert lib is not None and "krisp_tpu_torch" in lib._name


@pytest.fixture
def fastas(tmp_path):
    rng = np.random.default_rng(9)
    recs = []
    for i in range(4):
        seq = "".join(rng.choice(list("ACGTNacgtRY"), rng.integers(1, 300)))
        recs.append(f">rec{i} some description\n"
                    + "\n".join(seq[j:j + 60] for j in range(0, len(seq), 60))
                    + "\n")
    text = "".join(recs).encode()
    paths = {"plain": tmp_path / "g.fasta", "gz": tmp_path / "g.fa.gz",
             "bz2": tmp_path / "g.fna.bz2"}
    paths["plain"].write_bytes(text)
    paths["gz"].write_bytes(gzip.compress(text))
    paths["bz2"].write_bytes(bz2.compress(text))
    return {k: str(v) for k, v in paths.items()}


@pytest.mark.parametrize("kind", ["plain", "gz", "bz2"])
def test_load_buffer_matches_and_names_its_reader(fastas, kind, monkeypatch):
    path = fastas[kind]
    calls = []
    native = tnative.read_fasta_native
    monkeypatch.setattr(tnative, "read_fasta_native",
                        lambda p: calls.append(p) or native(p))
    got = tfasta.load_buffer(path)
    want = jfasta.load_buffer(path)
    np.testing.assert_array_equal(got, want)
    python_buf, names = tfasta.read_fasta_buffer(path)
    np.testing.assert_array_equal(python_buf, want)
    assert names == jfasta.read_fasta_buffer(path)[1]
    if kind == "bz2":
        assert calls == []              # the Python reader serves .bz2
    else:
        assert calls == [path]          # the native reader served it
        lib = tnative.get_lib()
        assert lib is not None and "krisp_tpu_torch" in lib._name
        np.testing.assert_array_equal(native(path)[0], want)
    assert tfasta.simple_name(path) == jfasta.simple_name(path)
    assert tfasta.bucket_size(70_000) == jfasta.bucket_size(70_000)


@pytest.mark.parametrize("argv", [
    ["in1.fasta.gz", "in2.fasta.gz", "--outgroup", "out1.fasta.gz",
     "--conserved-left", "25", "--conserved-right", "2", "--diagnostic",
     "1"],
    ["in1.gz", "--outgroup", "out1.gz", "out2.gz", "--conserved", "30",
     "--amplicon", "100", "--primer3", "--out_align", "alignments.txt",
     "--out_csv", "results.csv"],
    ["a.fa", "-c", "20", "-d", "3", "--omit-soft", "--dot-alignment",
     "--cores", "4", "--workdir", "tables", "--tm", "50", "60",
     "--no-primer3", "--verbose"],
])
def test_parse_args_matches(argv):
    assert vars(tcli.parse_args(argv)) == vars(jcli.parse_args(argv))


@pytest.mark.parametrize("writer,reader", [(tckpt, jckpt), (jckpt, tckpt)])
def test_table_cache_read_by_the_other_package(tmp_path, writer, reader):
    genome = tmp_path / "g.fasta"
    genome.write_text(">g\nACGTACGTAAAC\n")
    rng = np.random.default_rng(1)
    words = rng.integers(0, 2**32, (2, 50), dtype=np.uint64).astype(
        np.uint32)
    counts = rng.integers(1, 9, 50).astype(np.uint32)
    offsets = np.array([0, 20, 50], np.int64)
    geom = SimpleNamespace(left=25, mid=1, right=2)
    writer.TableCache(str(tmp_path / "wd")).store(
        str(genome), geom, 2, False, words, counts, offsets, 5)
    got = reader.TableCache(str(tmp_path / "wd")).load(str(genome), geom, 2,
                                                       False, 5)
    assert got is not None
    for g, w in zip(got, (words, counts, offsets)):
        np.testing.assert_array_equal(g, w)
    assert reader.TableCache(str(tmp_path / "wd")).load(
        str(genome), geom, 2, True, 5) is None    # another key
    assert (tckpt.TableCache(str(tmp_path / "wd")).manifest()
            == jckpt.TableCache(str(tmp_path / "wd")).manifest())


def _kstream_fasta(tmp_path, seed):
    """A seeded genome with N runs, soft-masked stretches and repeats."""
    rng = np.random.default_rng(seed)
    body = rng.choice(np.array(list("ACGTN")), 6000, p=[.24] * 4 + [.04])
    for s in rng.integers(0, 5700, 6):
        stretch = slice(s, s + rng.integers(20, 300))
        body[stretch] = np.char.lower(body[stretch])
    seq = "".join(body)
    path = tmp_path / "k.fasta"
    path.write_text(f">a\n{seq}{seq[:700]}\n>b\n{seq[2000:2500]}\n")
    return str(path)


def _kstream_both(run, path, args):
    """[krisp_tpu's, the port's] (line count, bytes) of ``run`` in each
    package's kstream_vec, called with ``args(package)``."""
    outs = []
    for pkg in (jvec, tvec):
        buf = io.BytesIO()
        n = getattr(pkg, run)(path, *args(pkg), buf)
        outs.append((n, buf.getvalue()))
    return outs


@pytest.mark.parametrize("k,mode,soft,host", [
    (28, "canonicals", "map", "native"), (28, "complements", "omit", "numpy"),
    (13, "plain", "map", "numpy"), (32, "canonicals", "omit", "native"),
    (40, "complements", "map", "native"), (64, "canonicals", "omit",
                                           "native")])
def test_kstream_host_engine_matches(tmp_path, monkeypatch, k, mode, soft,
                                     host):
    """``run_vec_kstream``: the native core (one u64 key to k = 32, two
    words to 64; the port's own build of its copy of kstreamcore.cpp) and
    the numpy path (``KRISP_TPU_KSTREAM_HOST=numpy``)."""
    monkeypatch.setenv("KRISP_TPU_KSTREAM_HOST", host)
    path = _kstream_fasta(tmp_path, k)
    kw = dict(kmers=k, disallow="Nn", sort=True,
              complements=mode == "complements",
              canonicals=mode == "canonicals", omitsoft=soft == "omit",
              mapsoft=soft == "map")
    plans = {jvec: jkd.device_plan(**kw), tvec: tkd.device_plan(**kw)}
    want, got = _kstream_both("run_vec_kstream", path,
                              lambda pkg: (plans[pkg],))
    assert got == want and want[0] > 100
    lib = tvec._load_core()
    assert lib is not None and "krisp_tpu_torch" in lib._name


@pytest.mark.parametrize("ks,mode", [([8, 20, 33], "canonicals"),
                                     ([5, 12], "complements")])
def test_kstream_multi_k_matches(tmp_path, ks, mode):
    path = _kstream_fasta(tmp_path, 3)
    want, got = _kstream_both("run_multi_k_kstream", path,
                              lambda pkg: (ks, mode, False, True))
    assert got == want and want[0] > 1000


def test_kstream_v2_split_sort_cols_matches(tmp_path):
    """``--split 25 -2 --sort-cols 0 2 --complements`` at k = 28: the
    native core's v2 entry."""
    path = _kstream_fasta(tmp_path, 25)
    kw = dict(kmers=28, disallow="Nn", sort=True, complements=True,
              split=[25, -2], sortcols=[0, 2], mapsoft=True)
    plans = {jvec: jkd.device_plan(**kw), tvec: tkd.device_plan(**kw)}
    assert plans[tvec].v2
    want, got = _kstream_both("run_vec_kstream", path,
                              lambda pkg: (plans[pkg],))
    assert got == want and want[0] > 1000 and b"," in want[1]
