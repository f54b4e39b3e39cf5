"""The port's per-genome key extraction and global stage vs krisp_tpu's on
the same host-packed genomes, each stage alone and cross-fed.  Integer
outputs: the tolerance is 0."""

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from krisp_tpu.engine import pipeline as JP  # noqa: E402
from krisp_tpu.ops import intersect as JI  # noqa: E402
from krisp_tpu_torch.convert import keys_from_numpy, keys_to_numpy  # noqa: E402
from krisp_tpu_torch.engine import pipeline as TP  # noqa: E402
from krisp_tpu_torch.ops.encode import KeyLayout  # noqa: E402
from krisp_tpu_torch.ops import intersect as TI  # noqa: E402

N_FILES = 3
P = 1 << 14


def _genomes(seed, L):
    """N_FILES random genomes (ACGTN, some lowercase) sharing planted
    regions, stacked into one padded buffer."""
    rng = np.random.default_rng(seed)
    shared = [rng.choice(np.frombuffer(b"ACGT", np.uint8), size=L + 3)
              for _ in range(4)]
    stacked = np.zeros((N_FILES, P), np.uint8)
    for f in range(N_FILES):
        seq = rng.choice(np.frombuffer(b"ACGTNacgt", np.uint8), size=P - 50,
                         p=[0.2] * 4 + [0.04] + [0.04] * 4)
        for i, s in enumerate(shared):
            pos = (i + 1) * (P - 200) // 5
            seq[pos:pos + s.size] = s
        stacked[f, :seq.size] = seq
    return stacked


def _jax_keys(stacked, geom):
    tables = JP._encoding_tables(2, False)
    keys = []
    for f in range(N_FILES):
        pk, vb = JP._pack_genomes_host(stacked[f:f + 1], False)
        keys.append(JI.extract_keys_packed_in(
            jax.device_put(pk), jax.device_put(vb), *tables, np.uint32(f),
            left=geom[0], mid=geom[1], right=geom[2], bits=2,
            n_files=N_FILES))
    return keys


def _port_keys(stacked, geom, omit_soft=False):
    keys = []
    for f in range(N_FILES):
        pk, vb = TP._pack_genomes_host(stacked[f:f + 1], omit_soft)
        keys.append(TI.extract_keys_packed_in(
            keys_from_numpy(pk, "cpu"), torch.from_numpy(vb), f, *geom, 2,
            N_FILES))
    return keys


def _port_global(keys, geom):
    """The port's global stage over per-genome tables; (words, counts,
    gid)."""
    layout = KeyLayout(*geom, 2, N_FILES)
    table = [torch.cat(keys, dim=1)]
    words, counts, gid, n_pre = TI.global_stage(table, layout, N_FILES)
    assert table == []                              # the stage took it
    assert n_pre == sum(k.shape[1] for k in keys)   # no prefilter
    return words, counts, gid


def _assert_global_equal(got, packed, W):
    words, counts, gid = got
    n_keep = int(packed[-1, 0])
    assert words.shape == (W, n_keep) and n_keep > 0
    np.testing.assert_array_equal(keys_to_numpy(words), packed[:W, :n_keep])
    np.testing.assert_array_equal(counts.numpy().astype(np.uint32),
                                  packed[W, :n_keep])
    np.testing.assert_array_equal(gid.numpy().astype(np.uint32),
                                  packed[W + 1, :n_keep])


@pytest.mark.parametrize("geom", [(25, 1, 2), (4, 1, 3), (5, 0, 5)])
def test_extract_and_global_match_jax(geom):
    stacked = _genomes(sum(geom), sum(geom))
    j_keys = _jax_keys(stacked, geom)
    t_keys = _port_keys(stacked, geom)
    for jk, tk in zip(j_keys, t_keys):
        assert tk.dtype == torch.int32
        np.testing.assert_array_equal(keys_to_numpy(tk), np.asarray(jk))

    packed = np.asarray(JI.fused_global_packed(
        tuple(j_keys), left=geom[0], mid=geom[1], right=geom[2], bits=2,
        n_files=N_FILES, cap=1 << 16))
    W = j_keys[0].shape[0]
    _assert_global_equal(_port_global(t_keys, geom), packed, W)
    # cross-fed: krisp_tpu's per-genome tables into the port's global stage
    fed = [keys_from_numpy(np.asarray(k), "cpu") for k in j_keys]
    _assert_global_equal(_port_global(fed, geom), packed, W)


def test_extract_omit_soft_folds_into_bitmap():
    """omit_soft lives in the host bitmap: lowercase windows become
    sentinel rows."""
    geom = (4, 1, 3)
    stacked = _genomes(9, sum(geom))
    soft = _port_keys(stacked, geom, omit_soft=True)
    hard = _port_keys(stacked, geom, omit_soft=False)
    for s, h in zip(soft, hard):
        s_rows = (s != -1).any(dim=0)
        h_rows = (h != -1).any(dim=0)
        assert bool((h_rows | ~s_rows).all()) and s_rows.sum() < h_rows.sum()
        assert torch.equal(s[:, s_rows], h[:, s_rows])


def test_compact_rows_in_order():
    keep = torch.tensor([False, True, True, False, True])
    a = torch.arange(10, dtype=torch.int32).reshape(2, 5)
    (out,), n_keep = TI.compact_rows([a], keep)
    assert n_keep == 3
    assert out.tolist() == [[1, 2, 4], [6, 7, 9]]


@pytest.mark.parametrize("geom", [(25, 1, 2), (4, 1, 3)])
def test_global_stage_scans_in_layout_mode(monkeypatch, geom):
    """The global stage's scan is the layout mode (validity from the
    keys, no valid_rows pass), which equals the valid-array call; the
    stage's outputs stay krisp_tpu's."""
    from krisp_tpu_torch.ops import scan as TS
    calls = []

    def layout_mode(keys, layout, n_files):
        got = TS.survivor_scan_layout(keys, layout, n_files)
        want = TS.survivor_scan(keys, TS.valid_rows(keys, layout),
                                layout.flank_bits,
                                layout.file_off + layout.file_bits, n_files)
        for g, r in zip(got, want):
            assert torch.equal(g, r)
        calls.append(keys.shape)
        return got

    monkeypatch.setattr(TI, "survivor_scan_layout", layout_mode)
    stacked = _genomes(sum(geom) + 1, sum(geom))
    j_keys = _jax_keys(stacked, geom)
    packed = np.asarray(JI.fused_global_packed(
        tuple(j_keys), left=geom[0], mid=geom[1], right=geom[2], bits=2,
        n_files=N_FILES, cap=1 << 16))
    _assert_global_equal(_port_global(_port_keys(stacked, geom), geom),
                         packed, j_keys[0].shape[0])
    assert len(calls) == 1
