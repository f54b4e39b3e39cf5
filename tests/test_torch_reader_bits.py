"""The encoding width of each genome buffer (``io.fasta.genome_bits``):
the native reader works it out as it copies the bases, and
``dna.choose_bits`` scans any other buffer (the Python fallback's for
``.bz2``, stdin or no native library, or an array ``load_buffer`` did not
return).  Either way it is ``choose_bits``'s answer on the buffer
``load_buffer`` returns, and the search's width is krisp_tpu's
``detect_bits`` on the same files."""

import gc
import gzip
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

from krisp_tpu.engine import pipeline as jpipeline  # noqa: E402
from krisp_tpu.io import fasta as jfasta  # noqa: E402
from krisp_tpu_torch import dna  # noqa: E402
from krisp_tpu_torch.engine import pipeline as tpipeline  # noqa: E402
from krisp_tpu_torch.io import fasta as tfasta  # noqa: E402
from krisp_tpu_torch.io import native as tnative  # noqa: E402

READERS = ("native", "python")


def _reader(monkeypatch, reader):
    """Leave the native library in place, or take it away so that every
    read falls back to the Python reader."""
    if reader == "python":
        monkeypatch.setattr(tnative, "get_lib", lambda: None)
    else:
        assert tnative.get_lib() is not None


def _byte_in_line(v):
    return b">r1 x\nACGTACGT\nAC" + bytes([v]) + b"GTA\n>r2\nacgtn\n"


#: name -> (file name, file bytes)
CASES = {f"byte-{v:02x}": ("g.fasta", _byte_in_line(v)) for v in range(256)}
CASES.update({f"header-{c}": ("g.fasta", f">r1 {c}{c.lower()}\nACGTN\n"
                              f">{c}\nacgt\n".encode())
              for c in dna.IUPAC_LETTERS + "@"})
CASES.update({
    "crlf": ("g.fasta", b">a\r\nACGT\r\nNNAC\r\n>b R\r\nAC\r\n"),
    "crlf-iupac": ("g.fasta", b">a\r\nACGT\r\nNKAC\r\n>b\r\nAC\r\n"),
    "raw-lines": ("g.txt", b"ACGT\nacgtn\nNNNN\n"),
    "raw-lines-iupac": ("g.txt", b"ACGT\nacYtn\nNNNN\n"),
    "gz": ("g.fa.gz", gzip.compress(b">a\nACGT\nACGT\n>b\nTTGA\n")),
    "gz-iupac": ("g.fa.gz", gzip.compress(b">a\nACGT\nACWT\n>b\nTTGA\n")),
    "empty": ("g.fasta", b""),
})


@pytest.mark.parametrize("reader", READERS)
@pytest.mark.parametrize("case", CASES)
def test_loader_gives_choose_bits_of_load_buffer(tmp_path, monkeypatch,
                                                 case, reader):
    name, data = CASES[case]
    path = tmp_path / name
    path.write_bytes(data)
    _reader(monkeypatch, reader)
    buf = tfasta.load_buffer(str(path))
    bits, by_reader = tfasta.genome_bits(buf)
    assert buf.dtype == np.uint8
    assert bits == dna.choose_bits(buf)
    assert by_reader == (reader == "native")


@pytest.mark.parametrize("made", ["copy", "half", "widened"])
def test_an_array_the_reader_did_not_return_is_scanned(tmp_path, made):
    """Only the very array the native reader returned carries its width: a
    copy, a part or an edited copy of it is classified by ``choose_bits``,
    and the reader's entry goes with its array."""
    path = tmp_path / "g.fasta"
    path.write_bytes(b">a R\nACGTNacgtn\nACGT\n>b\nTTGA\n")
    buf = tfasta.load_buffer(str(path))
    assert tfasta.genome_bits(buf) == (2, True)
    other = {"copy": buf.copy(),
             "half": np.ascontiguousarray(buf[:buf.size // 2]),
             "widened": np.where(buf == ord("T"), ord("Y"), buf)
             .astype(np.uint8)}[made]
    assert tfasta.genome_bits(other) == (dna.choose_bits(other), False)
    key = id(buf)
    assert key in tfasta._READER_BITS
    del buf, other              # "half" is a view that holds ``buf``
    gc.collect()
    assert key not in tfasta._READER_BITS


def _genomes(tmp_path, wide_last):
    """Four genomes of 2-bit bases; where ``wide_last`` the last one holds a
    single IUPAC letter near its end, the others none."""
    rng = np.random.default_rng(11)
    paths = []
    for f in range(4):
        seqs = ["".join(rng.choice(list("ACGTNacgtn"), 500))
                for _ in range(3)]
        if wide_last and f == 3:
            seqs[-1] = seqs[-1][:-3] + "M" + seqs[-1][-2:]
        path = tmp_path / f"g{f}.fasta"
        path.write_text("".join(f">s{i} RYK\n{s}\n" for i, s in
                                enumerate(seqs)))
        paths.append(str(path))
    return paths


@pytest.mark.parametrize("reader", READERS)
@pytest.mark.parametrize("wide_last", [False, True])
def test_search_width_is_krisp_tpu_detect_bits(tmp_path, monkeypatch,
                                               wide_last, reader):
    paths = _genomes(tmp_path, wide_last)
    _reader(monkeypatch, reader)
    buffers, bits = tpipeline._read_genomes(paths)
    for p, buf in zip(paths, buffers):
        np.testing.assert_array_equal(buf, tfasta.load_buffer(p))
    want = jpipeline.detect_bits([jfasta.load_buffer(p) for p in paths])
    assert bits == want == (4 if wide_last else 2)
    assert [tfasta.genome_bits(b)[0] for b in buffers] == \
        [2, 2, 2, 4 if wide_last else 2]


def test_the_reader_is_linked_aside_and_renamed_into_place(tmp_path,
                                                          monkeypatch):
    """Test workers build the native reader at first use, several at once:
    each links its own file and renames it into place, so that none loads
    another's half-written library."""
    import subprocess

    from krisp_tpu_torch import nativebuild
    lib_path = tmp_path / "libkrispio.so"
    linked = []
    run = subprocess.run

    def link(cmd, **kw):
        linked.append(Path(cmd[cmd.index("-o") + 1]))
        assert not lib_path.exists()
        return run(cmd, **kw)
    monkeypatch.setattr(nativebuild.subprocess, "run", link)
    lib = nativebuild.load_native("fastaio.cpp", lib_path,
                                  extra_flags=["-lz"])
    assert lib is not None and hasattr(lib, "kfasta_read")
    assert len(linked) == 1 and linked[0] != lib_path
    assert linked[0].parent == lib_path.parent
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["libkrispio.so", "libkrispio.so.srchash"]
