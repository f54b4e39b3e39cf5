"""The port's wide-key prefix prefilter (``fused_prefilter_global``) vs
krisp_tpu's, on the same per-genome key tables, and prefilter == direct
global stage on the port.  Integer outputs: the tolerance is 0.  krisp_tpu's
caps are set large enough that it never retries."""

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from krisp_tpu.engine import pipeline as JP  # noqa: E402
from krisp_tpu.ops import intersect as JI  # noqa: E402
from krisp_tpu_torch.convert import keys_from_numpy, split_packed  # noqa: E402
from krisp_tpu_torch.engine import pipeline as TP  # noqa: E402
from krisp_tpu_torch.ops.encode import KeyLayout  # noqa: E402
from krisp_tpu_torch.ops import intersect as TI  # noqa: E402

ACGT = np.frombuffer(b"ACGT", np.uint8)


def _amplicon_genomes(seed, F=3, n=4096):
    """tests/test_prefilter.py's genomes: random ACGTN with three shared
    100-base blocks, so survivors exist."""
    rng = np.random.default_rng(seed)
    buffers = rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=(F, n),
                         p=[0.24, 0.24, 0.24, 0.24, 0.04])
    for i in range(3):
        block = rng.choice(ACGT, size=100)
        buffers[:, 200 + i * 900:300 + i * 900] = block
    return buffers


def _at_repeat_genomes(F=2, n=2048):
    """Low complexity: nearly every prefix survives the prefilter."""
    rng = np.random.default_rng(99)
    buffers = np.tile(np.frombuffer(b"ATATATAT", np.uint8), (F, n // 8))
    for f in range(F):
        idx = rng.integers(0, n, 40)
        buffers[f, idx] = np.frombuffer(b"CG", np.uint8)[
            rng.integers(0, 2, 40)]
    return buffers


def _random_genomes(F=2, n=2048):
    rng = np.random.default_rng(5)
    return rng.choice(ACGT, size=(F, n))


def _both_2bit(buffers, geom, cap):
    """(port's output, krisp_tpu's packed output) over the same host pack."""
    F = buffers.shape[0]
    tables = JP._encoding_tables(2, False)
    j_keys, t_keys = [], []
    for f in range(F):
        pk, vb = JP._pack_genomes_host(buffers[f:f + 1], False)
        j_keys.append(JI.extract_keys_packed_in(
            jax.device_put(pk), jax.device_put(vb), *tables, np.uint32(f),
            left=geom[0], mid=geom[1], right=geom[2], bits=2, n_files=F))
        t_keys.append(TI.extract_keys_packed_in(
            keys_from_numpy(pk, "cpu"), torch.from_numpy(vb), f, *geom, 2, F))
    packed = np.asarray(JI.fused_prefilter_global(
        tuple(j_keys), left=geom[0], mid=geom[1], right=geom[2], bits=2,
        n_files=F, cap_pre=cap, cap=cap))
    return TI.fused_prefilter_global(t_keys, *geom, 2, F), packed


def _assert_equal(got, packed, W, cap):
    words, counts, gid, n_pre = got
    n_keep = int(packed[-1, 0])
    assert int(packed[-1, 1]) <= cap and n_keep <= cap   # no JAX retry
    assert n_pre == int(packed[-1, 1])
    assert words.shape == (W, n_keep)
    for g, w in zip((words, counts, gid), split_packed(packed, W)):
        assert g.dtype == torch.int32
        assert torch.equal(g, w)


@pytest.mark.parametrize("seed", range(3))
def test_prefilter_matches_jax_amplicon(seed):
    geom = (30, 40, 30)
    got, packed = _both_2bit(_amplicon_genomes(seed), geom, 1 << 12)
    _assert_equal(got, packed, 7, 1 << 12)
    assert got[0].shape[1] > 0


def test_prefilter_matches_jax_degenerate():
    buffers = _at_repeat_genomes()
    cap = 2 * 2 * buffers.shape[1]
    got, packed = _both_2bit(buffers, (30, 40, 30), cap)
    _assert_equal(got, packed, 7, cap)
    assert got[3] > 1000 and got[0].shape[1] > 0


def test_prefilter_no_survivors():
    """Random genomes share no 14-base prefix: the prefilter keeps no row
    and the full-width stage runs on an empty table."""
    got, packed = _both_2bit(_random_genomes(), (30, 40, 30), 1 << 12)
    _assert_equal(got, packed, 7, 1 << 12)
    assert got[3] == 0 and got[0].shape == (7, 0)
    assert got[1].shape == got[2].shape == (0,)


def test_prefilter_matches_jax_4bit():
    """IUPAC input: 4-bit 25/1/2 keys (4 words, a 7-base prefix),
    extracted from the raw bytes."""
    rng = np.random.default_rng(11)
    F, n = 3, 2048
    buffers = rng.choice(np.frombuffer(b"ACGTRYN", np.uint8), size=(F, n),
                         p=[0.23] * 4 + [0.03] * 2 + [0.02])
    block = rng.choice(ACGT, size=40)
    buffers[:, 600:640] = block
    geom, cap = (25, 1, 2), 1 << 14
    tables = JP._encoding_tables(4, False)
    packed = np.asarray(JI.fused_pipeline_prefilter(
        buffers, *tables, left=25, mid=1, right=2, bits=4, n_files=F,
        cap_pre=cap, cap=cap))
    t_keys = [TI.extract_keys_ascii(torch.from_numpy(buffers[f]), f, tables,
                                    *geom, 4, F) for f in range(F)]
    got = TI.fused_prefilter_global(t_keys, *geom, 4, F)
    _assert_equal(got, packed, 4, cap)
    assert got[3] > 0 and got[0].shape[1] > 0


@pytest.mark.parametrize("case", ["amplicon", "degenerate"])
def test_prefilter_equals_direct_on_port(case):
    buffers = (_amplicon_genomes(4) if case == "amplicon"
               else _at_repeat_genomes())
    F = buffers.shape[0]
    keys = []
    for f in range(F):
        pk, vb = TP._pack_genomes_host(buffers[f:f + 1], False)
        keys.append(TI.extract_keys_packed_in(
            keys_from_numpy(pk, "cpu"), torch.from_numpy(vb), f, 30, 40, 30,
            2, F))
    words, counts, gid, n_pre = TI.fused_prefilter_global(keys, 30, 40, 30,
                                                          2, F)
    n = sum(k.shape[1] for k in keys)
    d_words, d_counts, d_gid, d_n = TI.global_stage(
        [torch.cat(keys, dim=1)], KeyLayout(30, 40, 30, 2, F), F,
        prefilter=False)
    assert words.shape[1] > 0 and n_pre < n == d_n
    assert torch.equal(words, d_words) and torch.equal(counts, d_counts)
    # group ids number flank runs of tables of different sizes: compare
    # the grouping, not the numbers
    assert torch.equal(gid.diff() != 0, d_gid.diff() != 0)
