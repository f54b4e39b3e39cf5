"""The port's copies of krisp_tpu's JAX-free helpers stay equal to the
originals, and its table-driven window_keys_tree equals krisp_tpu's."""

import pytest

pytest.importorskip("jax")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from krisp_tpu import dna  # noqa: E402
from krisp_tpu.engine import pipeline as JP  # noqa: E402
from krisp_tpu.ops import encode as JE  # noqa: E402
from krisp_tpu_torch.convert import keys_to_numpy  # noqa: E402
from krisp_tpu_torch.engine import pipeline as TP  # noqa: E402
from krisp_tpu_torch.ops import encode as TE  # noqa: E402

GEOMS = [(4, 1, 3), (10, 4, 10), (25, 1, 2), (30, 40, 30), (5, 0, 5),
         (17, 3, 2), (1, 0, 1), (0, 3, 16)]


@pytest.mark.parametrize("geom", GEOMS)
@pytest.mark.parametrize("n_files", [1, 2, 5, 16, 100])
def test_key_layout_copy(geom, n_files):
    for bits in (2, 4):
        a = JE.KeyLayout(*geom, bits, n_files)
        b = TE.KeyLayout(*geom, bits, n_files)
        assert vars(a) == vars(b)
        assert a.base_offsets() == b.base_offsets()
        assert a.file_word_shift() == b.file_word_shift()
        assert a._key() == b._key()
        assert hash(b) == hash(TE.KeyLayout(*geom, bits, n_files))
    assert JE.sort_perm(*geom) == TE.sort_perm(*geom)


@pytest.mark.parametrize("geom", GEOMS)
def test_word_runs_copy(geom):
    left, mid, right = geom
    L = left + mid + right
    layout = TE.KeyLayout(left, mid, right, 2, 5)
    perm = (tuple(range(left)) + tuple(range(left + mid, L))
            + tuple(range(left, left + mid)))
    off_flank, off_mid = layout.base_offsets()
    offs = tuple(off_flank) + tuple(off_mid)
    want = dict(JE._word_runs(perm, offs, 2))
    assert dict(TE._word_runs(perm, offs, 2)) == want
    assert dict(TE.layout_runs(layout)) == want


def test_geometry_helpers_copy():
    cases = [dict(amplicon=100, diagnostic=40), dict(amplicon=100, conserved=30),
             dict(amplicon=60, conserved_left=25, conserved_right=2),
             dict(diagnostic=1, conserved=20),
             dict(diagnostic=1, conserved_left=25, conserved_right=2)]
    for kw in cases:
        a, b = JP.solve_geometry(**kw), TP.solve_geometry(**kw)
        assert (a.left, a.mid, a.right, a.total) == (b.left, b.mid, b.right,
                                                     b.total)
    for kw in [dict(), dict(amplicon=10), dict(diagnostic=3)]:
        with pytest.raises(ValueError):
            JP.solve_geometry(**kw)
        with pytest.raises(ValueError):
            TP.solve_geometry(**kw)
    rng = np.random.default_rng(0)
    for alphabet in (b"ACGTNacgtn", b"ACGTRYN"):
        bufs = [rng.choice(np.frombuffer(alphabet, np.uint8), size=500)
                for _ in range(3)]
        assert JP.detect_bits(bufs) == TP.detect_bits(bufs)
    for bits in (2, 4):
        for omit in (False, True):
            for x, y in zip(JP._encoding_tables(bits, omit),
                            TP._encoding_tables(bits, omit)):
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("omit_soft", [False, True])
def test_pack_genomes_host_copy(omit_soft):
    rng = np.random.default_rng(1)
    stacked = rng.choice(np.frombuffer(b"ACGTNacgtn\0", np.uint8),
                         size=(3, 4096))
    for x, y in zip(JP._pack_genomes_host(stacked, omit_soft),
                    TP._pack_genomes_host(stacked, omit_soft)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_group_epilogue_copy():
    rng = np.random.default_rng(2)
    geom_j, geom_t = JP.KmerGeometry(3, 2, 2), TP.KmerGeometry(3, 2, 2)
    n = 40
    gid = np.sort(rng.integers(0, 8, n)).astype(np.int64)
    flanks = ["".join(rng.choice(list("ACGT"), 5)) for _ in range(8)]
    flank_dec = [flanks[g] for g in gid]
    mid_dec = ["".join(rng.choice(list("ACGT"), 2)) for _ in range(n)]
    fid = rng.integers(0, 3, n).astype(np.uint32)
    cnt = rng.integers(1, 5, n).astype(np.uint32)
    tags = ["a", "b", "c"]
    for filt in (False, True):
        args = (n, gid, mid_dec, flank_dec, fid, cnt)
        rest = (tags, frozenset(["a", "b"]), True, filt)
        got = TP._group_epilogue(*args, geom_t, *rest)
        want = JP._group_epilogue(*args, geom_j, *rest)
        rep = lambda gs: [(g.left, g.right, sorted(g.ingroup),  # noqa: E731
                           [(a.mid, a.label_counts) for a in g.amplicons])
                          for g in gs]
        assert rep(got) == rep(want)


@pytest.mark.parametrize("geom", [(4, 1, 3), (10, 4, 10), (25, 1, 2)])
def test_window_keys_tree_matches_jax(geom):
    rng = np.random.default_rng(3)
    buf = rng.choice(np.frombuffer(b"ACGTNacgt", np.uint8), size=3000)
    tables = JP._encoding_tables(2, False)
    ok_j, words_j = JE.window_keys_tree(buf, *tables, *geom, 5)
    ok_t, words_t = TE.window_keys_tree(torch.from_numpy(buf), *tables,
                                        *geom, 5)
    ok_j = np.asarray(ok_j)
    np.testing.assert_array_equal(ok_t.numpy(), ok_j)
    for wj, wt in zip(words_j, words_t):
        np.testing.assert_array_equal(keys_to_numpy(wt)[ok_j],
                                      np.asarray(wj)[ok_j])


@pytest.mark.parametrize("geom", [(25, 1, 2), (4, 1, 3), (30, 40, 30)])
@pytest.mark.parametrize("omit_soft", [False, True])
def test_window_keys_bits_matches_jax(geom, omit_soft):
    """4-bit (IUPAC) window keys: the softmask policy lives in the
    validity table, so lower-case windows drop out under omit_soft."""
    rng = np.random.default_rng(sum(geom) + omit_soft)
    alphabet = np.frombuffer(b"ACGTRYKMSWN", np.uint8)
    buf = rng.choice(alphabet, size=3000, p=[0.24] * 4 + [0.005] * 6 + [0.01])
    for start in (200, 1400, 2500):                # soft-masked runs
        buf[start:start + 150] |= 0x20
    tables = JP._encoding_tables(4, omit_soft)
    ok_j, words_j = JE.window_keys_bits(buf, *tables, *geom, 4, 5)
    ok_t, words_t = TE.window_keys_bits(torch.from_numpy(buf), *tables,
                                        *geom, 4, 5)
    ok_j = np.asarray(ok_j)
    assert ok_j.any() and not ok_j.all()
    np.testing.assert_array_equal(ok_t.numpy(), ok_j)
    assert len(words_t) == TE.KeyLayout(*geom, 4, 5).n_words
    for wj, wt in zip(words_j, words_t):
        assert wt.dtype == torch.int32
        np.testing.assert_array_equal(keys_to_numpy(wt), np.asarray(wj))
