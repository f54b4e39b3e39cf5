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
