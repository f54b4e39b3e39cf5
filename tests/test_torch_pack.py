"""Plain window-key packing of the port vs krisp_tpu's Pallas kernel
(interpret mode) and its XLA path; the table mode's plain version vs
krisp_tpu's per-genome tables; a line-by-line emulation of the CUDA
kernel's sliding stretches and halo vs the plain version; the port's 2-bit
unpack and host pack vs krisp_tpu's.  Integer outputs: the tolerance is
0."""

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
from krisp_tpu_torch.ops.encode import KeyLayout  # noqa: E402
from krisp_tpu_torch.ops.pack import (_run_table,  # noqa: E402
                                      window_keys_both,
                                      window_keys_both_reference,
                                      window_keys_table,
                                      window_keys_table_reference)


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


def _emulate_window_keys(buf, L, W, runs, omit_soft, table=False, fword=-1,
                         fvalue=0, threads=4, stretch=4):
    """csrc/window_keys.cu's window_keys_kernel, line by line, with
    ``threads`` x ``stretch`` windows a block (the kernel: 256 x 16).
    Returns (ok, fwd, rc) or, with ``table``, the int32 table
    [W, 2 n_win] as u32."""
    P = buf.size
    n_win = max(P - L + 1, 0)     # the C entry launches nothing at 0
    tile, pitch = threads * stretch, stretch + 1
    ok = np.zeros(n_win, np.uint8)
    fwd = np.zeros((W, 2 * n_win if table else n_win), np.uint64)
    rc = np.zeros((W, n_win), np.uint64)
    M32 = 0xFFFFFFFF
    for block in range(-(-n_win // tile)):
        start = block * tile
        span = min(P - start, tile + L - 1)
        s_code = np.zeros(tile + L - 1, np.int64)
        for j in range(tile + L - 1):
            if j < span:
                b = int(buf[start + j])
                upper = b & 0xDF
                y = (upper >> 1) & 3
                code = y ^ (y >> 1)
                valid = upper in b"ACGT"
                if omit_soft and b & 0x20:
                    valid = False
                s_code[j] = code | (4 if valid else 0)
        s_f = np.zeros(threads * pitch, np.uint64)
        s_c = np.zeros(threads * pitch, np.uint64)
        state = []
        for t in range(threads):
            j0 = t * stretch
            i0 = start + j0
            bad = sum(not s_code[j0 + k] & 4 for k in range(L - 1))
            okbits = 0
            for s in range(stretch):
                bad += not s_code[j0 + s + L - 1] & 4
                okbits |= (bad == 0) << s
                bad -= not s_code[j0 + s] & 4
            if not table:
                for s in range(stretch):
                    if i0 + s < n_win:
                        ok[i0 + s] = (okbits >> s) & 1
            state.append((j0, okbits))
        r_of = [0] * threads
        for w in range(W):
            for t, (j0, okbits) in enumerate(state):
                af, ac = [0] * stretch, [0] * stretch
                r = r_of[t]
                while r < len(runs) and runs[r][0] == w:
                    _, p0, bit0, m = runs[r]
                    lsh, hsh = 32 - bit0 - 2 * m, 30 - bit0
                    mask = ((M32 if m == 16 else (1 << 2 * m) - 1)
                            << lsh) & M32
                    fp, cp = j0 + p0 + m - 1, j0 + L - 1 - p0
                    f = c = 0
                    for s in range(1 - m, stretch):
                        f = ((f << 2) & mask) | (s_code[fp + s] & 3) << lsh
                        c = (((c >> 2) & mask)
                             | (3 - (s_code[cp + s] & 3)) << hsh)
                        if s >= 0:
                            af[s] |= f
                            ac[s] |= c
                    r += 1
                r_of[t] = r
                for s in range(stretch):
                    if table:
                        if w == fword:
                            af[s] |= fvalue
                            ac[s] |= fvalue
                        if not (okbits >> s) & 1:
                            af[s] = ac[s] = M32
                    s_f[t * pitch + s] = af[s]
                    s_c[t * pitch + s] = ac[s]
            for x in range(tile):
                if start + x >= n_win:
                    break
                a = (x // stretch) * pitch + x % stretch
                if table:
                    fwd[w, start + x] = s_f[a]
                    fwd[w, n_win + start + x] = s_c[a]
                else:
                    fwd[w, start + x] = s_f[a]
                    rc[w, start + x] = s_c[a]
    if table:
        return fwd.astype(np.uint32)
    return ok.astype(bool), fwd.astype(np.uint32), rc.astype(np.uint32)


@pytest.mark.parametrize("geom,size,omit_soft", [
    ((0, 1, 0), 37, False),      # L = 1
    ((4, 1, 3), 16 + 7, False),  # n_win = one tile
    ((4, 1, 3), 17 + 7, True),   # one window past a tile
    ((25, 1, 2), 15 + 27, False),
    ((25, 1, 2), 301, True),     # stretches cross the halo of many tiles
    ((10, 4, 10), 200, False),
    ((30, 40, 30), 260, True),   # 7 words, runs of 16 bases
    ((30, 40, 30), 99, False),   # P = L - 1: no window
    ((25, 1, 2), 20, True),      # P < L - 1: no window
    ((0, 1, 0), 0, False),       # an empty buffer
])
def test_window_keys_kernel_emulation_matches_plain(geom, size, omit_soft):
    buf = _buffer(sum(geom) + size, size)[:size]
    L = sum(geom)
    buf[:L] = np.frombuffer(b"ACGT" * 25, np.uint8)[:min(L, size)]
    layout = KeyLayout(*geom, 2, 5)
    runs = _run_table(layout, torch.device("cpu")).tolist()
    b = torch.from_numpy(buf)
    ok_t, fwd_t, rc_t = window_keys_both_reference(b, *geom, 2, 5, omit_soft)
    ok_e, fwd_e, rc_e = _emulate_window_keys(buf, L, layout.n_words, runs,
                                             omit_soft)
    np.testing.assert_array_equal(ok_e, ok_t.numpy())
    np.testing.assert_array_equal(fwd_e[:, ok_e],
                                  keys_to_numpy(fwd_t)[:, ok_e])
    np.testing.assert_array_equal(rc_e[:, ok_e], keys_to_numpy(rc_t)[:, ok_e])
    fword, fshift = layout.file_word_shift()
    table_t = window_keys_table_reference(b, 3, *geom, 5, omit_soft)
    table_e = _emulate_window_keys(buf, L, layout.n_words, runs, omit_soft,
                                   True, fword, 3 << fshift)
    np.testing.assert_array_equal(table_e, keys_to_numpy(table_t))
    if size >= L:
        assert ok_e.any()


@pytest.mark.parametrize("geom", [(25, 1, 2), (4, 1, 3), (30, 40, 30)])
@pytest.mark.parametrize("omit_soft", [False, True])
def test_window_keys_table_plain_matches_jax_tables(geom, omit_soft):
    """The table mode's plain version, genome by genome, equals krisp_tpu's
    ``_all_window_keys`` block of that genome (XLA path), and, without
    omit_soft, its ``extract_keys_packed_in`` on the host-packed genome."""
    stacked = np.stack([_buffer(sum(geom) + f, 3004) for f in range(3)])
    tables = JP._encoding_tables(2, omit_soft)
    flat, _ = JI._all_window_keys(stacked, *tables, *geom, 2, 3, False,
                                  omit_soft)
    flat = np.stack([np.asarray(w) for w in flat])
    n = flat.shape[1] // 3
    for f in range(3):
        got = window_keys_table_reference(torch.from_numpy(stacked[f]), f,
                                          *geom, 3, omit_soft)
        np.testing.assert_array_equal(keys_to_numpy(got),
                                      flat[:, f * n:(f + 1) * n])
        # into a column slice of a wider table, as the pipeline writes it
        wide = torch.zeros((flat.shape[0], 3 * n), dtype=torch.int32)
        window_keys_table(torch.from_numpy(stacked[f]), f, *geom, 3,
                          omit_soft, out=wide[:, f * n:(f + 1) * n])
        cols = slice(f * n, (f + 1) * n)
        np.testing.assert_array_equal(keys_to_numpy(wide[:, cols]),
                                      flat[:, cols])
        if not omit_soft:
            pk, vb = JP._pack_genomes_host(stacked[f:f + 1], False)
            want = JI.extract_keys_packed_in(pk, vb, *tables, np.uint32(f),
                                             left=geom[0], mid=geom[1],
                                             right=geom[2], bits=2,
                                             n_files=3)
            np.testing.assert_array_equal(
                keys_to_numpy(TI.extract_keys_packed_in(
                    keys_from_numpy(pk, "cpu"), torch.from_numpy(vb), f,
                    *geom, 2, 3)),
                np.asarray(want))


def test_window_keys_table_checks_out():
    buf = torch.from_numpy(_buffer(3, 500))
    before = window_keys_table.launches
    with pytest.raises(ValueError, match="unit column stride"):
        window_keys_table(buf, 0, 25, 1, 2, 5,
                          out=torch.zeros((2, 2 * 473), dtype=torch.int32))
    with pytest.raises(ValueError, match="unit column stride"):
        window_keys_table(buf, 0, 25, 1, 2, 5,
                          out=torch.zeros((946, 2), dtype=torch.int32).T)
    assert window_keys_table.launches == before   # no kernel on the CPU
