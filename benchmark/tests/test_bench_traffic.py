"""The genome generator: deterministic by seed, the same sizes for every
seed, and each mix what its file says."""

import hashlib

import numpy as np
import pytest

from benchmark import genomes
from benchmark.reference.fasta_search import read_fasta
from benchmark.tests import tiny

SEED = 2**31 + 77


def _digest(gset):
    h = hashlib.sha256()
    for p in gset.paths:
        with open(p, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()


@pytest.mark.parametrize("mix", tiny.TRAFFIC)
def test_deterministic_by_seed(tmp_path, mix):
    cfg = tiny.config("spacer-5x40Mb")
    a = genomes.make_genomes(cfg, tiny.traffic(mix), SEED, tmp_path / "a")
    b = genomes.make_genomes(cfg, tiny.traffic(mix), SEED, tmp_path / "b")
    c = genomes.make_genomes(cfg, tiny.traffic(mix), SEED + 1, tmp_path / "c")
    assert _digest(a) == _digest(b) != _digest(c)
    assert a.contig_lengths == c.contig_lengths
    assert [k for k, _, _ in a.planted] == [k for k, _, _ in c.planted]
    assert len(a.paths) == cfg["genomes"] and len(a.ingroup) == cfg["ingroup"]
    assert all(sum(c) == cfg["genome_bases"] for c in a.contig_lengths)


def test_negative_and_huge_seeds(tmp_path):
    cfg = tiny.config("spacer-5x40Mb", 20_000)
    for i, seed in enumerate((-5, 2**64 + 3, 0)):
        genomes.make_genomes(cfg, tiny.traffic("distant"), seed,
                             tmp_path / str(i))


def test_related_substitution_rate(tmp_path):
    """Each genome differs from the ancestor at about 5 % of its bases
    (four standard errors), away from planted regions and N runs."""
    bases = 400_000
    cfg = tiny.config("spacer-5x40Mb", bases)
    tr = tiny.traffic("related")
    g = genomes.make_genomes(cfg, tr, SEED, tmp_path)
    ancestor = genomes.ACGT[genomes.rng_for(SEED, 0).integers(
        0, 4, bases, dtype=np.uint8)]
    rate = tr["substitution_rate"]
    L = sum(cfg["window"].values())
    mask = np.ones(bases, bool)
    for _, _, pos in g.planted:
        mask[pos:pos + L] = False
    for path in g.paths:
        seq = read_fasta(path)
        seq = seq[seq != 0]
        keep = mask & (seq != ord("N"))
        diff = (seq[keep] != ancestor[keep]).mean()
        se = (rate * (1 - rate) / keep.sum()) ** 0.5
        assert abs(diff - rate) < 4 * se, (path, diff)


def test_distant_genomes_are_independent(tmp_path):
    g = genomes.make_genomes(tiny.config("spacer-5x40Mb", 200_000),
                             tiny.traffic("distant"), SEED, tmp_path)
    a, b = (read_fasta(p) for p in g.paths[:2])
    assert 0.70 < (a != b).mean() < 0.80   # 3/4 for independent bases


def test_iupac_places_its_letters(tmp_path):
    bases = 500_000
    tr = tiny.traffic("iupac")
    g = genomes.make_genomes(tiny.config("spacer-5x40Mb", bases), tr, SEED,
                             tmp_path)
    every = tr["iupac_every"]
    want = np.arange(every // 2, bases, every)
    for path in g.paths:
        seq = read_fasta(path)
        seq = seq[seq != 0]
        letters = np.isin(seq, np.frombuffer(b"RYSWKM", np.uint8))
        at = np.flatnonzero(letters)
        # every letter where it belongs; an N run or a plant may cover one
        assert set(at) <= set(want) and len(at) >= len(want) - 2
    assert g.four_bit


@pytest.mark.parametrize("mix", tiny.TRAFFIC)
def test_mix_sets_only_what_sets_it_apart(mix):
    """A mix names its own parameters; the assembly's shape is
    ``genomes.SHAPE``'s in every mix."""
    tr = tiny.traffic(mix)
    assert set(tr) == {"about", "substitution_rate", "iupac_every"}


def test_case_gaps_and_contigs(tmp_path):
    tr = genomes.SHAPE
    g = genomes.make_genomes(tiny.config("spacer-5x40Mb", 400_000),
                             tiny.traffic("distant"), SEED, tmp_path)
    raw = open(g.paths[0], "rb").read()
    assert raw.count(b">") == tr["contigs"]
    body = raw.replace(b"\n", b"")
    assert body != body.upper()
    assert b"N" * tr["n_gaps"]["length"] in body
    lines = raw.split(b"\n")
    assert max(len(x) for x in lines if not x.startswith(b">")) \
        == tr["line_width"]


def test_planted_kinds_in_both_halves():
    kinds = genomes._slot_kinds(genomes.SHAPE["planted"])
    half = len(kinds) // 2
    for k in ("diagnostic", "partial", "missing_one", "n_in_one", "mixed",
              "repeated", "shared"):
        assert k in kinds[:half] and k in kinds[half:], k


def test_unknown_kind_is_refused():
    with pytest.raises(ValueError):
        genomes._slot_kinds({"diagnostc": 1})
