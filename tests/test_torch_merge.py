"""The port's merge_sorted_words (its plain version on the CPU) vs krisp_tpu's
Pallas merge in interpret mode, and the port's A/B entry point.  Integer
outputs: the tolerance is 0."""

import pytest

pytest.importorskip("jax")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from krisp_tpu.ops.pallas_merge import merge_sorted_words as jax_merge  # noqa: E402
from krisp_tpu_torch.convert import keys_from_numpy, keys_to_numpy  # noqa: E402
from krisp_tpu_torch.ops import merge as TM  # noqa: E402
from krisp_tpu_torch.tools import ab_merge_path  # noqa: E402


def _to_words(x64):
    return np.stack([(x64 >> 32).astype(np.uint32), x64.astype(np.uint32)])


def _sorted_u64_runs(na, nb, seed, high=2**63):
    rng = np.random.default_rng(seed)
    return (np.sort(rng.integers(0, high, na, dtype=np.uint64)),
            np.sort(rng.integers(0, high, nb, dtype=np.uint64)))


def _sorted_words(rng, V, n, pool=None):
    """uint32[V, n] rows sorted as unsigned tuples; ``pool`` draws every
    word from a few values (heavy ties, top-bit and all-ones words)."""
    if pool is None:
        w = rng.integers(0, 2**32, (V, n), dtype=np.uint64).astype(np.uint32)
    else:
        w = np.asarray(pool, np.uint32)[rng.integers(0, len(pool), (V, n))]
    return w[:, np.lexsort(tuple(w[::-1]))]


def _case(name):
    """(A, B) uint32[V, n] of the cases of tests/test_pallas_merge.py, plus
    3- and 7-word tables."""
    if name.startswith("u64_"):
        na, nb = map(int, name[4:].split("_"))
        return tuple(_to_words(x) for x in _sorted_u64_runs(na, nb,
                                                            na * 31 + nb))
    if name == "cross_run_duplicates":
        A = np.sort(np.random.default_rng(7).integers(0, 2**40, 4096,
                                                      dtype=np.uint64))
        return _to_words(A), _to_words(A.copy())
    if name == "heavy_ties":
        A, B = _sorted_u64_runs(6000, 3000, 11, high=7)
        return _to_words(A), _to_words(B)
    if name == "one_word":
        A, B = _sorted_u64_runs(2500, 1500, 3, high=2**32)
        return A.astype(np.uint32)[None], B.astype(np.uint32)[None]
    rng = np.random.default_rng(len(name))
    pool = [0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF]
    if name == "three_words_ties":
        return _sorted_words(rng, 3, 3000, pool), _sorted_words(rng, 3, 1100,
                                                                pool)
    assert name == "seven_words"
    return _sorted_words(rng, 7, 1500), _sorted_words(rng, 7, 2600)


CASES = ["u64_1024_1024", "u64_3000_500", "u64_1_2048", "u64_999_1",
         "u64_0_1024", "u64_1024_0", "u64_0_0", "u64_5000_7000",
         "u64_40960_8192", "cross_run_duplicates", "heavy_ties", "one_word",
         "three_words_ties", "seven_words"]


@pytest.mark.parametrize("name", CASES)
def test_merge_matches_jax(name):
    A, B = _case(name)
    want = np.asarray(jax_merge(A, B, interpret=True))
    got = TM.merge_sorted_words(keys_from_numpy(A, "cpu"),
                                keys_from_numpy(B, "cpu"))
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(keys_to_numpy(got), want)
    both = np.concatenate([A, B], axis=1)
    np.testing.assert_array_equal(want, both[:, np.lexsort(tuple(both[::-1]))])


def test_merge_refuses_mixed_devices_and_widths():
    a = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError):
        TM.merge_sorted_words(a, torch.zeros((2, 3), dtype=torch.int32,
                                             device="meta"))
    assert TM.merge_sorted_words.launches == 0   # the CPU never launches


def test_ab_merge_path_on_cpu():
    """The JAX tool's keys (seed 5, u63 split into hi and lo words); arm B
    (two sorts and a merge) equals arm A (one sort) bit for bit."""
    n = 5000
    keys = np.random.default_rng(5).integers(0, 2**63, 2 * n,
                                             dtype=np.uint64)
    np.testing.assert_array_equal(ab_merge_path.ab_keys(n), _to_words(keys))
    out = ab_merge_path.run(n=n, reps=1, device="cpu")
    assert out["bit_parity"] is True
    assert out["n_total"] == 2 * n and out["backend"] == "cpu"
    keys_jax_tool = {"metric", "n_total", "unit", "sort_2n_s", "sort_n_s",
                     "sort_n2_s", "merge_s", "b_total_s", "b_vs_a",
                     "merge_mkeys_per_s", "bit_parity", "backend"}
    assert keys_jax_tool <= set(out)
    assert all(out[k] > 0 for k in ("sort_2n_s", "merge_s", "b_vs_a"))


def test_ab_merge_path_cli(capsys):
    import json
    assert ab_merge_path.main(["--n", "300", "--reps", "1",
                               "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["bit_parity"] is True and out["n_total"] == 600
