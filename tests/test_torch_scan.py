"""The port's plain survivor scan vs krisp_tpu's Pallas survivor scan
(interpret mode) and survivor_mark_bits.  Integer outputs: the tolerance
is 0."""

import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from krisp_tpu.ops import intersect as JI  # noqa: E402
from krisp_tpu.ops.encode import KeyLayout  # noqa: E402
from krisp_tpu.ops.pallas_scan import TILE, pallas_survivor_scan  # noqa: E402
from krisp_tpu_torch.convert import keys_from_numpy  # noqa: E402
from krisp_tpu_torch.ops import scan as TS  # noqa: E402


def _table(seed, n, n_files, geom=(5, 1, 3)):
    """A sorted table with long runs at every granularity: few distinct
    flank values, genome ids in [0, n_files) and some sentinel ids."""
    rng = np.random.default_rng(seed)
    layout = KeyLayout(*geom, 2, n_files)
    W = layout.n_words
    words = np.stack([rng.integers(0, 6, n).astype(np.uint32) << 28
                      for _ in range(W)])
    fw, fsh = layout.file_word_shift()
    words[fw] &= ~np.uint32(layout.file_sentinel << fsh)
    ids = rng.integers(0, n_files, n).astype(np.uint32)
    ids[rng.random(n) < 0.05] = layout.file_sentinel
    words[fw] |= ids << fsh
    words = words[:, np.lexsort(tuple(words[::-1]))]
    valid = ((words[fw] >> np.uint32(fsh)) & np.uint32(layout.file_sentinel)
             ) != layout.file_sentinel
    return layout, words, valid


def _port(layout, words, valid, n_files):
    keep, counts, gid = TS.survivor_scan(
        keys_from_numpy(words, "cpu"), torch.from_numpy(valid),
        layout.flank_bits, layout.file_off + layout.file_bits, n_files)
    assert (keep.dtype, counts.dtype, gid.dtype) == (torch.bool, torch.int32,
                                                     torch.int32)
    return keep.numpy(), counts.numpy(), gid.numpy()


@pytest.mark.parametrize("n_files", [2, 3, 5])
@pytest.mark.parametrize("n", [TILE, 40_000])
def test_scan_matches_pallas_and_xla(n_files, n):
    layout, words, valid = _table(n_files + n, n, n_files)
    keep, counts, gid = _port(layout, words, valid, n_files)
    assert keep.any() and not keep.all()

    # survivor_mark_bits recomputes validity from the key itself
    k_x, c_x, g_x = JI.survivor_mark_bits([jnp.asarray(w) for w in words],
                                          layout, n_files)
    np.testing.assert_array_equal(keep, np.asarray(k_x))
    np.testing.assert_array_equal(counts, np.asarray(c_x).astype(np.int64))
    np.testing.assert_array_equal(gid, np.asarray(g_x))

    # the Pallas kernel takes whole tiles: pad only its side with sentinels
    n_pad = -(-n // TILE) * TILE
    w_pad = np.full((words.shape[0], n_pad), 0xFFFFFFFF, np.uint32)
    w_pad[:, :n] = words
    v_pad = np.zeros(n_pad, np.uint32)
    v_pad[:n] = valid
    k_p, c_p, g_p = pallas_survivor_scan(
        w_pad, v_pad, layout.flank_bits, layout.file_off + layout.file_bits,
        n_files, interpret=True)
    np.testing.assert_array_equal(keep, np.asarray(k_p)[:n])
    np.testing.assert_array_equal(counts, np.asarray(c_p)[:n])
    np.testing.assert_array_equal(gid, np.asarray(g_p)[:n])


@pytest.mark.parametrize("geom", [(25, 1, 2), (16, 0, 0), (3, 2, 3)])
def test_scan_geometries_match_xla(geom):
    """Boundary-word masks: 54 and 58 bits (25/1/2), a whole-word flank
    (16/0/0) and a short flank."""
    n_files = 5
    layout, words, valid = _table(sum(geom), 6000, n_files, geom)
    keep, counts, gid = _port(layout, words, valid, n_files)
    k_x, c_x, g_x = JI.survivor_mark_bits([jnp.asarray(w) for w in words],
                                          layout, n_files)
    np.testing.assert_array_equal(keep, np.asarray(k_x))
    np.testing.assert_array_equal(counts, np.asarray(c_x).astype(np.int64))
    np.testing.assert_array_equal(gid, np.asarray(g_x))


def test_scan_wrapper_routes_cpu_to_plain():
    layout, words, valid = _table(0, 3000, 3)
    before = TS.survivor_scan.launches
    _port(layout, words, valid, 3)
    assert TS.survivor_scan.launches == before   # no kernel on the CPU


def test_masked_head_matches_jax():
    _, words, _ = _table(4, 2000, 5, (25, 1, 2))
    t = keys_from_numpy(words, "cpu")
    jw = [jnp.asarray(w) for w in words]
    for bits in (0, 20, 32, 54, 58, 60):
        np.testing.assert_array_equal(TS._masked_head(t, bits).numpy(),
                                      np.asarray(JI._masked_head(jw, bits)))
    np.testing.assert_array_equal(TS._run_heads(t).numpy(),
                                  np.asarray(JI._run_heads(jw)))
