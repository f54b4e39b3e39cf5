"""The port's variant classifier (``krisp_tpu_torch.ops.vcfclass``, torch
ops on the CPU here) against krisp_tpu's JAX functions on JAX's CPU
backend, as ``tests/test_vcfclass_device.py`` runs them: ``classify_batch``,
``classify_batch_packed`` and ``classify_bits_packed_small`` on the same
seeded numpy batches, equal bit for bit (tolerance 0) and equal to the
numpy mirrors, with float32 boundary sweeps of both threshold
comparisons."""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from krisp_tpu.ops import vcfclass as jvc  # noqa: E402
from krisp_tpu_torch.ops import vcfclass as tvc  # noqa: E402

KEYS = ("sample_counts", "allele_counts", "conserved", "diagnostic")
KW = dict(min_samples=3, min_reads=10, min_geno_qual=40, min_freq=0.1,
          min_map_qual=30, min_var_qual=10, min_samp_prop=0.9)


def _batch(seed, V, S, A, G, *, missing=0.1, empty_group=False,
           unused=0.1, all_missing_rows=0):
    """A random batch in ``classify_batch``'s layout: missing calls (-1),
    depths and qualities on both sides of the gates, n_alleles <= A,
    samples outside every group (-1) and, if asked, a group of size 0 and
    rows whose every sample is missing."""
    rng = np.random.default_rng(seed)
    dp = rng.integers(0, 40, (V, S)).astype(np.int32)
    gq = rng.integers(0, 99, (V, S)).astype(np.int32)
    miss = rng.random((V, S)) < missing
    dp[miss] = -1
    gq[miss] = -1
    n_alleles = rng.integers(1, A + 1, V).astype(np.int32)
    ad = rng.integers(0, 30, (V, S, A)).astype(np.int32)
    # sparse allele depths; depths past n_alleles stay, for the mask to drop
    ad *= rng.random((V, S, A)) < 0.5
    # most samples carry the variant's one allele only, so groups can agree
    solo = rng.random((V, S)) < 0.8
    pick = np.broadcast_to(rng.integers(0, n_alleles)[:, None], (V, S))
    one = np.zeros_like(ad)
    np.put_along_axis(one, pick[:, :, None], 40, axis=2)
    ad = np.where(solo[:, :, None], one, ad)
    if all_missing_rows:
        dp[:all_missing_rows] = -1
        gq[:all_missing_rows] = -1
        ad[:all_missing_rows] = 0
    group_id = rng.integers(0, G, S).astype(np.int32)
    group_id[rng.random(S) < unused] = -1
    if empty_group:
        group_id[group_id == G - 1] = -1
    sizes = np.bincount(group_id[group_id >= 0], minlength=G).astype(np.int32)
    mq = np.where(rng.random(V) < 0.1, -1.0,
                  rng.uniform(0, 60, V)).astype(np.float32)
    qual = np.where(rng.random(V) < 0.1, -1.0,
                    rng.uniform(0, 100, V)).astype(np.float32)
    return dict(dp=dp, gq=gq, ad=ad, n_alleles=n_alleles, mq=mq, qual=qual,
                group_id=group_id, group_sizes=sizes)


def _torch(arrays):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in arrays.items()}


def _bits_args(arrays, kw):
    gate, counted = jvc.host_gate_counted_bits(
        arrays["dp"], arrays["gq"], arrays["ad"], arrays["n_alleles"],
        kw["min_reads"], kw["min_geno_qual"], kw["min_freq"])
    return gate, counted


def _small_kw(kw):
    return {k: kw[k] for k in ("min_samples", "min_map_qual", "min_var_qual",
                               "min_samp_prop")}


def _assert_same(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _check_all(arrays, kw):
    """Every classifier of the port equals krisp_tpu's, and the mirrors."""
    G = int(arrays["group_sizes"].shape[0])
    V, S, A = arrays["ad"].shape
    t = _torch(arrays)
    want = jvc.classify_batch(n_groups=G, **arrays, **kw)
    got = tvc.classify_batch(n_groups=G, **t, **kw)
    for k in KEYS:
        _assert_same(got[k], want[k])
    want_p = np.asarray(jvc.classify_batch_packed(n_groups=G, **arrays, **kw))
    _assert_same(tvc.classify_batch_packed(n_groups=G, **t, **kw), want_p)
    _assert_same(tvc.pack_outputs(got, V), want_p)
    mirror = tvc.classify_batch_packed_numpy(n_groups=G, **arrays, **kw)
    _assert_same(mirror, want_p)
    _assert_same(jvc.classify_batch_packed_numpy(n_groups=G, **arrays, **kw),
                 mirror)

    gate, counted = _bits_args(arrays, kw)
    tg, tc = tvc.host_gate_counted_bits(
        arrays["dp"], arrays["gq"], arrays["ad"], arrays["n_alleles"],
        kw["min_reads"], kw["min_geno_qual"], kw["min_freq"])
    _assert_same(tg, gate)
    _assert_same(tc, counted)
    want_s = np.asarray(jvc.classify_bits_packed_small(
        gate, counted, arrays["mq"], arrays["qual"], arrays["group_id"],
        arrays["group_sizes"], n_groups=G, n_samples=S, n_alleles=A,
        **_small_kw(kw)))
    got_s = tvc.classify_bits_packed_small(
        torch.from_numpy(gate), torch.from_numpy(counted), t["mq"],
        t["qual"], t["group_id"], t["group_sizes"], n_groups=G, n_samples=S,
        n_alleles=A, **_small_kw(kw))
    _assert_same(got_s, want_s)
    _assert_same(tvc.pack_outputs_small(got, V), want_s)
    # the small layout's columns are the packed layout's, presence as bits
    sc_cd = mirror[:, :3 * G]
    np.testing.assert_array_equal(want_s[:, :3 * G], sc_cd.astype(np.int16))
    present = mirror[:, 3 * G:].reshape(V, G, A) > 0
    bits = (present * (1 << np.arange(A))).sum(axis=2)
    np.testing.assert_array_equal(want_s[:, 3 * G:], bits.astype(np.int16))
    _assert_same(tvc.allele_counts_rows_numpy(
        arrays["dp"], arrays["gq"], arrays["ad"], arrays["n_alleles"],
        arrays["group_id"], G, kw["min_reads"], kw["min_geno_qual"],
        kw["min_freq"]), mirror[:, 3 * G:].reshape(V, G, A))
    return want


CASES = {
    # name: (seed, V, S, A, G, batch options)
    "g2_a1": (1, 40, 12, 1, 2, {}),
    "g2_a2": (2, 60, 16, 2, 2, {}),
    "g3_a4": (3, 70, 20, 4, 3, {}),
    "g4_a8": (4, 50, 24, 8, 4, {}),
    "g5_a15": (5, 40, 30, 15, 5, {}),
    "one_group": (6, 60, 10, 3, 1, {"unused": 0.0}),
    "all_missing_rows": (7, 30, 12, 3, 3, {"all_missing_rows": 10}),
    "empty_group": (8, 40, 18, 3, 4, {"empty_group": True}),
    "unused_samples": (9, 40, 20, 2, 2, {"unused": 0.5}),
    "dense_missing": (10, 40, 16, 5, 3, {"missing": 0.6}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_classifiers_equal_jax(case):
    seed, V, S, A, G, opts = CASES[case]
    arrays = _batch(seed, V, S, A, G, **opts)
    kw = dict(KW, min_reads=int(seed % 3) * 5 + 1,
              min_samples=1 + seed % 3, min_geno_qual=20, min_samp_prop=0.4)
    want = _check_all(arrays, kw)
    if case == "all_missing_rows":
        # no sample passes the gates: no counts, no calls
        assert not np.asarray(want["sample_counts"])[:10].any()
        assert (np.asarray(want["conserved"])[:10] == -1).all()
    # the batch reaches both calls somewhere, so the comparison bites
    if case in ("g2_a1", "one_group", "g3_a4"):
        assert (np.asarray(want["conserved"]) >= 0).any()
    if case == "empty_group":
        assert arrays["group_sizes"][-1] == 0


def test_cohort_batch_equal_jax():
    """The cohort generator of the card tests, at a small size."""
    from torch_vcf_inputs import cohort_batch
    want = _check_all(cohort_batch(5, 96, 40, 8, 4), KW)
    assert (np.asarray(want["conserved"]) >= 0).any()
    assert (np.asarray(want["diagnostic"]) >= 0).any()


def test_diagnostic_calls_equal_jax():
    """Groups fixed for different alleles: diagnostic calls are made (and
    equal), including an allele index past the first."""
    V, S, A, G = 32, 12, 4, 3
    rng = np.random.default_rng(12)
    group_id = np.repeat(np.arange(G, dtype=np.int32), S // G)
    allele = rng.integers(0, A, (V, G))
    ad = np.zeros((V, S, A), np.int32)
    for v in range(V):
        for s in range(S):
            ad[v, s, allele[v, group_id[s]]] = 30
    arrays = dict(dp=np.full((V, S), 30, np.int32),
                  gq=np.full((V, S), 60, np.int32), ad=ad,
                  n_alleles=np.full(V, A, np.int32),
                  mq=np.full(V, 60, np.float32),
                  qual=np.full(V, 900, np.float32), group_id=group_id,
                  group_sizes=np.full(G, S // G, np.int32))
    want = _check_all(arrays, KW)
    diag = np.asarray(want["diagnostic"])
    assert (diag >= 1).any() and (diag == -1).any()


@pytest.mark.parametrize("min_freq", [0.1, 0.3, 1 / 3, 0.7])
def test_min_freq_boundary_sweep(min_freq):
    """Every (ad, depth) split with depth 1-100 over two and three alleles:
    ``ad >= depth_sum * f32(min_freq)`` decides each allele's count, and
    the port decides as JAX does, also where float64 would not (at 0.3,
    depth 50 is the first such split of all-float64 math)."""
    rows = []
    for depth in range(1, 101):
        for a in range(depth + 1):
            rows.append((a, depth - a, 0))
            if depth - a >= 2:
                rows.append((a, 1, depth - a - 1))
    ad = np.array(rows, np.int32)[:, None, :]              # (V, 1, 3)
    V = ad.shape[0]
    arrays = dict(dp=np.full((V, 1), 50, np.int32),
                  gq=np.full((V, 1), 99, np.int32), ad=ad,
                  n_alleles=np.full(V, 3, np.int32),
                  mq=np.full(V, 60, np.float32),
                  qual=np.full(V, 900, np.float32),
                  group_id=np.zeros(1, np.int32),
                  group_sizes=np.ones(1, np.int32))
    kw = dict(KW, min_freq=min_freq, min_samples=1)
    want = _check_all(arrays, kw)
    counted = np.asarray(want["allele_counts"])[:, 0, :] > 0
    depth = ad[:, 0, :].sum(axis=1, keepdims=True)
    f32 = (ad[:, 0, :] > 0) & (ad[:, 0, :].astype(np.float32)
                               >= depth.astype(np.float32)
                               * np.float32(min_freq))
    np.testing.assert_array_equal(counted, f32)
    # the sweep holds splits that float64 math decides the other way: with
    # the threshold as a double, or rounded to float32 but multiplied in
    # float64 (at 0.7 every exact product rounds alike in all three)
    f64 = (ad[:, 0, :] > 0) & (ad[:, 0, :] >= depth * min_freq)
    mixed = (ad[:, 0, :] > 0) & (ad[:, 0, :] >= depth
                                 * float(np.float32(min_freq)))
    assert (f32 != f64).any() or (f32 != mixed).any() or min_freq == 0.7


@pytest.mark.parametrize("min_samp_prop", [0.9, 0.5, 1 / 3, 0.7, 0.95,
                                           0.1, 2 / 3, 0.8])
def test_min_samp_prop_boundary_sweep(min_samp_prop):
    """``sample_counts / max(group_size, 1) >= f32(min_samp_prop)`` for
    every count 0-20 of every group size 0-20: conserved calls equal JAX's,
    9 of 10 at 0.9 passes (in float64, 0.9f < 0.9 would fail it)."""
    S = 20
    V = S + 1
    dp = np.full((V, S), 5, np.int32)
    for k in range(V):
        dp[k, :k] = 50                       # k samples pass the gate
    base = dict(dp=dp, gq=np.full((V, S), 99, np.int32),
                ad=np.tile(np.array([40, 0], np.int32), (V, S, 1)),
                n_alleles=np.full(V, 2, np.int32),
                mq=np.full(V, 60, np.float32),
                qual=np.full(V, 900, np.float32),
                group_id=np.zeros(S, np.int32))
    kw = dict(KW, min_samp_prop=min_samp_prop, min_samples=1)
    for size in range(0, S + 1):
        arrays = dict(base, group_sizes=np.array([size], np.int32))
        want = _check_all(arrays, kw)
        consv = np.asarray(want["conserved"])[:, 0]
        prop = (np.arange(V, dtype=np.float32)
                / np.float32(max(size, 1)))
        expect = (np.arange(V) >= 1) & (prop >= np.float32(min_samp_prop))
        np.testing.assert_array_equal(consv == 0, expect)
    if min_samp_prop == 0.9:
        arrays = dict(base, group_sizes=np.array([10], np.int32))
        consv = tvc.classify_batch(n_groups=1, **_torch(arrays), **kw)[
            "conserved"]
        assert int(consv[9, 0]) == 0
        assert np.float32(9) / np.float32(10) == np.float32(0.9)
        assert float(np.float32(0.9)) < 0.9


def test_cpu_calls_are_not_counted():
    """The launch counters count batches a card ran; CPU calls add none."""
    arrays = _batch(3, 8, 6, 2, 2)
    before = (tvc.classify_batch.launches, tvc.classify_batch_packed.launches,
              tvc.classify_bits_packed_small.launches)
    _check_all(arrays, KW)
    assert (tvc.classify_batch.launches, tvc.classify_batch_packed.launches,
            tvc.classify_bits_packed_small.launches) == before
