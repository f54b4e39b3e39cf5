"""Plain window-key packing of the port vs krisp_tpu's Pallas kernel
(interpret mode) and its XLA path; the port's 2-bit unpack and host pack
vs krisp_tpu's.  Integer outputs: the tolerance is 0."""

import pytest

pytest.importorskip("jax")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from krisp_tpu import dna  # noqa: E402
from krisp_tpu.engine import pipeline as JP  # noqa: E402
from krisp_tpu.ops import intersect as JI  # noqa: E402
from krisp_tpu.ops.encode import window_keys_bits  # noqa: E402
from krisp_tpu.ops.pallas_pack import pallas_window_keys_both  # noqa: E402
from krisp_tpu_torch.convert import keys_from_numpy, keys_to_numpy  # noqa: E402
from krisp_tpu_torch.engine import pipeline as TP  # noqa: E402
from krisp_tpu_torch.ops import intersect as TI  # noqa: E402
from krisp_tpu_torch.ops.pack import (window_keys_both,  # noqa: E402
                                      window_keys_both_reference)


def _buffer(seed, size):
    rng = np.random.default_rng(seed)
    # mostly upper-case bases, so that long windows and omit_soft keep
    # valid windows
    p = [0.225] * 4 + [0.02] + [0.02] * 4
    seq = rng.choice(np.frombuffer(b"ACGTNacgt", np.uint8), size=size, p=p)
    return np.concatenate([seq, np.zeros(100, np.uint8)])


@pytest.mark.parametrize("geom,omit_soft", [
    ((4, 1, 3), False), ((10, 4, 10), False), ((25, 1, 2), False),
    ((30, 40, 30), False), ((10, 2, 10), True), ((4, 1, 3), True)])
def test_window_keys_match_pallas_and_xla(geom, omit_soft):
    buf = _buffer(sum(geom), 5000)
    L = sum(geom)
    n_win = buf.size - L + 1
    n_files = 5
    ok_t, fwd_t, rc_t = window_keys_both_reference(
        torch.from_numpy(buf), *geom, 2, n_files, omit_soft=omit_soft)
    assert ok_t.shape == (n_win,) and fwd_t.dtype == torch.int32

    ok_p, fwd_p, rc_p = pallas_window_keys_both(
        buf, *geom, 2, n_files, omit_soft=omit_soft, interpret=True)
    ok_p = np.asarray(ok_p)[:n_win]
    np.testing.assert_array_equal(ok_t.numpy(), ok_p)

    valid_t = dna.base_validity_table(2, disallow="Nn", omit_soft=omit_soft)
    ok_x, words_x = window_keys_bits(buf, dna.CODE2_TABLE, valid_t,
                                     dna.COMP2_TABLE, *geom, 2, n_files)
    ok_x = np.asarray(ok_x)
    np.testing.assert_array_equal(ok_x[:n_win], ok_p)
    assert ok_p.any()
    for w in range(fwd_t.shape[0]):
        f, r = keys_to_numpy(fwd_t[w])[ok_p], keys_to_numpy(rc_t[w])[ok_p]
        np.testing.assert_array_equal(f, np.asarray(fwd_p[w])[:n_win][ok_p])
        np.testing.assert_array_equal(r, np.asarray(rc_p[w])[:n_win][ok_p])
        np.testing.assert_array_equal(f, np.asarray(words_x[w])[:n_win][ok_p])
        np.testing.assert_array_equal(
            r, np.asarray(words_x[w])[n_win:][ok_p])


def test_window_keys_wrapper_routes_cpu_to_plain():
    buf = torch.from_numpy(_buffer(7, 2000))
    before = window_keys_both.launches
    got = window_keys_both(buf, 25, 1, 2, 2, 5)
    want = window_keys_both_reference(buf, 25, 1, 2, 2, 5)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert window_keys_both.launches == before   # no kernel on the CPU
    with pytest.raises(NotImplementedError):
        window_keys_both(buf, 25, 1, 2, 4, 5)


def test_window_keys_all_t_flank_has_top_bit():
    buf = torch.from_numpy(np.frombuffer(b"T" * 40, np.uint8).copy())
    ok, fwd, rc = window_keys_both(buf, 25, 1, 2, 2, 5)
    assert bool(ok.all())
    assert keys_to_numpy(fwd[0])[0] == 0xFFFFFFFF   # all-T flank word
    assert keys_to_numpy(rc[0])[0] == 0             # its revcomp: all A


@pytest.mark.parametrize("omit_soft", [False, True])
def test_unpack_genomes_matches_jax(omit_soft):
    rng = np.random.default_rng(11)
    stacked = rng.choice(np.frombuffer(b"ACGTNacgt\0", np.uint8),
                         size=(2, 8192))
    pk, vb = TP._pack_genomes_host(stacked, omit_soft)
    want = np.asarray(JI.unpack_genomes(pk, vb))
    got = TI.unpack_genomes(keys_from_numpy(pk, "cpu"), torch.from_numpy(vb))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    # same per-base (code, validity) as the raw bytes under the policy
    valid = dna.base_validity_table(2, disallow="Nn", omit_soft=omit_soft)
    np.testing.assert_array_equal(got.numpy() != ord("N"), valid[stacked])
    np.testing.assert_array_equal(JP._pack_genomes_host(stacked, omit_soft)[0],
                                  pk)
