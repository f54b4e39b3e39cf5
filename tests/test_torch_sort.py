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
