"""The port's lsd_sort / sort_rows vs krisp_tpu's, on keys with sentinel
rows and top-bit-set words.  Integer outputs: the tolerance is 0."""

import pytest

pytest.importorskip("jax")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from krisp_tpu.ops import sort as JS  # noqa: E402
from krisp_tpu_torch.convert import keys_from_numpy, keys_to_numpy  # noqa: E402
from krisp_tpu_torch.ops import sort as TS  # noqa: E402


def _keys(rng, W, n):
    """Few distinct values per word (many ties), all-ones sentinel rows,
    and words whose top bit is set."""
    pool = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xC0000000, 0xFFFFFFFE,
                     0xFFFFFFFF], np.uint32)
    words = pool[rng.integers(0, pool.size, (W, n))]
    words[:, rng.random(n) < 0.1] = 0xFFFFFFFF
    return words


@pytest.mark.parametrize("W", [1, 2, 3])
@pytest.mark.parametrize("entry", ["lsd_sort", "sort_rows"])
def test_sort_matches_jax(W, entry):
    rng = np.random.default_rng(W)
    words = _keys(rng, W, 5000)
    got, _ = getattr(TS, entry)([keys_from_numpy(w, "cpu") for w in words])
    want, _ = getattr(JS, entry)(list(words))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(keys_to_numpy(g), np.asarray(w))
    # and the order is the unsigned lexicographic one
    order = np.lexsort(tuple(words[::-1]))
    np.testing.assert_array_equal(np.stack([keys_to_numpy(g) for g in got]),
                                  words[:, order])


@pytest.mark.parametrize("W", [1, 2, 3])
def test_sort_payload_stability_matches_jax(W):
    rng = np.random.default_rng(10 + W)
    n = 4000
    words = _keys(rng, W, n)
    rowid = np.arange(n, dtype=np.uint32)
    extra = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    got_k, got_p = TS.lsd_sort([keys_from_numpy(w, "cpu") for w in words],
                               [keys_from_numpy(rowid, "cpu"),
                                keys_from_numpy(extra, "cpu")])
    want_k, want_p = JS.lsd_sort(list(words), [rowid, extra])
    for g, w in zip(got_k + got_p, want_k + want_p):
        np.testing.assert_array_equal(keys_to_numpy(g), np.asarray(w))
    # stable: equal keys keep their input order
    np.testing.assert_array_equal(keys_to_numpy(got_p[0]),
                                  np.lexsort(tuple(words[::-1])))


def test_group64_round_trip():
    rng = np.random.default_rng(5)
    words = [keys_from_numpy(w, "cpu") for w in _keys(rng, 3, 300)]
    groups, meta = TS._group64(words)
    assert meta == [2, 1] and groups[0].dtype == torch.int64
    for a, b in zip(TS._ungroup64(groups, meta), words):
        assert torch.equal(a, b)


@pytest.mark.parametrize("V", [1, 2, 3, 7])
def test_sort_words_reference_matches_bitonic(V):
    """The plain version of the sort kernel vs the Pallas bitonic network
    it replaces (interpret mode)."""
    from krisp_tpu.ops.pallas_sort import bitonic_sort_words
    rng = np.random.default_rng(20 + V)
    words = _keys(rng, V, 1000)     # one 1,024-row block after padding
    got = TS.sort_words_reference(keys_from_numpy(words, "cpu"))
    want = bitonic_sort_words(words, interpret=True, block_rows=8)
    assert got.dtype == torch.int32 and got.shape == words.shape
    np.testing.assert_array_equal(keys_to_numpy(got), np.asarray(want))
    # a CPU tensor takes the plain version
    assert torch.equal(TS.sort_words(keys_from_numpy(words, "cpu")), got)


@pytest.mark.parametrize("W,P", [(1, 1), (3, 2)])
def test_sort_rows_order_free_payloads_match_jax(monkeypatch, W, P):
    """With order-free payloads both packages sort them as trailing words
    (krisp_tpu's Pallas backend, run by the interpreter; small blocks keep
    the interpreted network short)."""
    from krisp_tpu.ops import pallas_sort
    monkeypatch.setenv("KRISP_TPU_PALLAS_SORT", "interpret")
    monkeypatch.setattr(pallas_sort, "_block_rows", lambda V: 8)
    rng = np.random.default_rng(30 + W)
    words = _keys(rng, W, 1000)
    payloads = rng.integers(0, 3, (P, 1000)).astype(np.uint32)
    got_k, got_p = TS.sort_rows([keys_from_numpy(w, "cpu") for w in words],
                                [keys_from_numpy(p, "cpu") for p in payloads],
                                order_free_payloads=True)
    want_k, want_p = JS.sort_rows(list(words), list(payloads),
                                  order_free_payloads=True)
    assert len(got_k) == W and len(got_p) == P
    for g, w in zip(got_k + got_p, want_k + want_p):
        np.testing.assert_array_equal(keys_to_numpy(g), np.asarray(w))


def test_sort_rows_ordered_payloads_stay_stable():
    rng = np.random.default_rng(40)
    words = _keys(rng, 2, 3000)
    rowid = np.arange(3000, dtype=np.uint32)
    got_k, (got_p,) = TS.sort_rows([keys_from_numpy(w, "cpu") for w in words],
                                   [keys_from_numpy(rowid, "cpu")])
    want_k, (want_p,) = JS.sort_rows(list(words), [rowid])
    for g, w in zip(got_k + [got_p], want_k + [want_p]):
        np.testing.assert_array_equal(keys_to_numpy(g), np.asarray(w))


def test_sort_with_rowid_matches_jax():
    """All-T prefixes (top bit set) sort before the all-ones sentinel, and
    equal keys keep their input order."""
    rng = np.random.default_rng(50)
    key = _keys(rng, 1, 5000)[0]
    key[:7] = 0xFFFFFFF0
    got_k, got_i = TS.sort_with_rowid(keys_from_numpy(key, "cpu"))
    want_k, want_i = JS.sort_with_rowid(key)
    np.testing.assert_array_equal(keys_to_numpy(got_k), np.asarray(want_k))
    assert got_i.dtype == torch.int64
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_i.numpy(),
                                  np.argsort(key, kind="stable"))


def test_sorts_take_no_rows():
    empty = torch.zeros((3, 0), dtype=torch.int32)
    assert TS.sort_words(empty).shape == (3, 0)
    keys, payloads = TS.sort_rows(list(empty[:2]), [empty[2]],
                                  order_free_payloads=True)
    assert [k.numel() for k in keys + payloads] == [0, 0, 0]
    key, rowid = TS.sort_with_rowid(empty[0])
    assert key.numel() == rowid.numel() == 0


def _fold(words):
    """csrc/sort_words.cu's vary_kernel on uint32[V, n]: over the rows that
    are not all ones, the OR of each word and of its complement, and the
    flags (bit 0: a row is all ones, bit 1: a row is not)."""
    sent = (words == 0xFFFFFFFF).all(axis=0)
    rest = words[:, ~sent]
    ones = [int(np.bitwise_or.reduce(w)) if w.size else 0 for w in rest]
    zeros = [int(np.bitwise_or.reduce(~w)) if w.size else 0 for w in rest]
    return ones, zeros, int(sent.any()) | 2 * int((~sent).any())


def _plan(words):
    return TS.sort_pass_plan(TS.varying_masks(*_fold(words)))


def _layout_table(tmp_path, geom, iupac):
    """A path's global table from the port's own table stage (CPU) on five
    random genomes: padding and record ends give all-ones sentinel rows."""
    from krisp_tpu_torch.engine import pipeline as TP
    rng = np.random.default_rng(7)
    paths = []
    for f in range(5):
        seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=6000)
        if iupac:
            seq[::3000] = ord("R")
        path = tmp_path / f"g{f}.fa"
        path.write_bytes(b">g\n" + seq.tobytes() + b"\n")
        paths.append(str(path))
    flat, _ = TP.genome_key_tables(paths, TP.KmerGeometry(*geom),
                                   device="cpu")
    return keys_to_numpy(flat)


@pytest.mark.parametrize("name,geom,iupac,passes,passes_all_bits", [
    ("spacer", (25, 1, 2), False, 7, 8),
    ("amplicon", (30, 40, 30), False, 26, 28),
    ("iupac", (25, 1, 2), True, 15, 16)])
def test_sort_pass_plan_of_path_tables(tmp_path, name, geom, iupac, passes,
                                       passes_all_bits):
    """The valid rows of a path's table vary in its base and genome-id
    bits: at 25/1/2, 59 bits (the fourth id bit, bit 9, stays 0 for 5
    genomes; bits 0-3 are unused).  The sentinel rows add one bit, that
    fourth id bit, not every bit: 60 bits in 7 passes of up to 9 bits,
    where all 64 would take 8.  Wider keys (index mode) take each word on
    its own."""
    words = _layout_table(tmp_path, geom, iupac)
    sent = (words == 0xFFFFFFFF).all(axis=0)
    assert sent.any() and not sent.all()
    plan = _plan(words)
    assert len(plan) == passes
    assert len(TS.sort_pass_plan([0xFFFFFFFF] * words.shape[0])) == \
        passes_all_bits
    masks = TS.varying_masks(*_fold(words))
    valid = TS.varying_masks(*_fold(words[:, ~sent]))
    assert sum(bin(m).count("1") for m in masks) == \
        sum(bin(m).count("1") for m in valid) + 1
    if name == "spacer":
        assert valid == [0xFFFFFFFF, 0xFFFFFDF0]
        assert masks == [0xFFFFFFFF, 0xFFFFFFF0]     # and bit 9
        assert plan == [(4 + 9 * k, 9) for k in range(6)] + [(58, 6)]
    for lo, w in plan:
        assert 1 <= w <= TS.DIGIT_BITS
        if words.shape[0] > TS.KEY_MODE_WORDS:
            assert lo // 32 == (lo + w - 1) // 32


@pytest.mark.parametrize("ones,zeros,flags,masks", [
    ([0, 0], [0, 0], 1, [0, 0]),                     # only sentinels
    ([5, 5], [~5 & 0xFFFFFFFF] * 2, 2, [0, 0]),      # all rows equal
    ([5, 5], [~5 & 0xFFFFFFFF] * 2, 3, [1 << 31, 0]),  # and sentinels
    ([0xFFFFFFFF, 7], [0, ~1 & 0xFFFFFFFF], 3, [0, 6 | 1 << 31]),
    ([0xFFFFFFFF, 0xFFFFFFFF], [0, 1], 3, [0, 1]),   # no 0 bit left
    ([0x0F, 0xFF], [0xFFFFFFF1, 0xFFFFFF00], 3, [0x80000001, 0]),
])
def test_varying_masks(ones, zeros, flags, masks):
    assert TS.varying_masks(ones, zeros, flags) == masks


@pytest.mark.parametrize("masks,plan", [
    ([0], []),                                       # no varying bit
    ([0, 0, 0], []),
    ([1 << 17], [(17, 1)]),                          # a single bit
    ([0x80000000], [(31, 1)]),                       # bit 31 of a word
    ([0x80000001], [(0, 1), (31, 1)]),               # bits 0 and 31
    ([1, 0], [(32, 1)]),                             # bit 0 of word 0
    ([0x1, 0x80000000], [(31, 2)]),                  # across the words
    ([0xFFFFFFFF] * 2, [(8 * k, 8) for k in range(8)]),   # all 64 bits
    ([0xFFFFFFFF] * 3,                               # 96 bits: 11 passes
     [(9 * k, 9) for k in range(10)] + [(90, 6)]),
    ([0xFFFFFFFF] * 4,                               # index mode: per word
     [(32 * v + 8 * k, 8) for v in range(4) for k in range(4)]),
    ([0x0FFFFFFF, 0xFFFFFFF0], [(4 + 8 * k, 8) for k in range(7)]),
    ([0x1, 0, 0, 0x80000000], [(31, 1), (96, 1)]),   # index mode
    ([0x1FF], [(0, 9)]),
    ([0x3FF], [(0, 5), (5, 5)]),
])
def test_sort_pass_plan_edges(masks, plan):
    assert TS.sort_pass_plan(masks) == plan


def _digit(words, V, lo, width):
    """csrc/sort_words.cu's make_digit and digit_of on uint32[V, n]."""
    w_lo, shift = V - 1 - lo // 32, lo % 32
    x = words[w_lo].astype(np.uint64)
    if shift + width > 32:
        x |= words[w_lo - 1].astype(np.uint64) << np.uint64(32)
    return (x >> np.uint64(shift)) & np.uint64((1 << width) - 1)


@pytest.mark.parametrize("V", [1, 2, 3, 4, 7, 9])
@pytest.mark.parametrize("dist", ["random", "narrow", "ties", "sentinels"])
def test_sort_passes_by_plan_sort_the_rows(V, dist):
    """Stable passes over the plan's digits, taken as the kernel takes them
    (in key mode digits that span two words, in index mode each word's
    digits alone), sort the rows: the LSD logic of the kernel against the
    unsigned lexicographic order.  "sentinels" mixes all-ones rows into
    rows whose high bits are constant zeros, so that one bit orders them."""
    rng = np.random.default_rng(V * 100 + len(dist))
    n = 3000
    if dist == "ties":
        words = _keys(rng, V, n)
    else:
        words = rng.integers(0, 2**32, (V, n), dtype=np.uint64).astype(
            np.uint32)
        if dist == "narrow":   # a few varying bits, straddling word ends
            keep = np.array([0x8000000F] + [0x00F00001] * (V - 1), np.uint32)
            words &= keep[:V, None]
        if dist == "sentinels":
            words[0] &= np.uint32(0x00FFFFFF)
            words[:, rng.random(n) < 0.2] = 0xFFFFFFFF
    plan = _plan(words)
    for lo, width in plan:
        assert 1 <= width <= TS.DIGIT_BITS and lo + width <= 32 * V
        assert V <= TS.KEY_MODE_WORDS or lo // 32 == (lo + width - 1) // 32
    rows = words
    for lo, width in plan:
        rows = rows[:, np.argsort(_digit(rows, V, lo, width), kind="stable")]
    np.testing.assert_array_equal(rows,
                                  words[:, np.lexsort(tuple(words[::-1]))])
