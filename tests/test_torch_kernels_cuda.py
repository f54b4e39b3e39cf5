"""The CUDA kernels vs their plain PyTorch versions on the card.  Needs an
NVIDIA GPU and nvcc; skipped elsewhere.  Integer outputs: the tolerance
is 0.  Run on the card with ``python -m pytest tests/test_torch_kernels_cuda.py``."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from krisp_tpu_torch.ops import merge, pack, scan, sort
from krisp_tpu_torch.ops.encode import KeyLayout
from torch_scan_tables import edge_table, edge_tables

pytestmark = pytest.mark.cuda

_SCAN_SRC = (Path(scan.__file__).resolve().parents[1] / "csrc"
             / "survivor_scan.cu").read_text()
SCAN_TILE, SCAN_AHEAD = (int(re.search(rf"constexpr int {k} = (\d+);",
                                       _SCAN_SRC).group(1))
                         for k in ("kTile", "kAhead"))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _window_buffer(seed, size):
    rng = np.random.default_rng(seed)
    # rare N and lower case, so that L = 100 under omit_soft keeps windows
    p = [0.245] * 4 + [0.004] * 5
    return rng.choice(np.frombuffer(b"ACGTNacgt", np.uint8), size=size, p=p)


@pytest.mark.parametrize("geom", [(25, 1, 2), (4, 1, 3), (10, 4, 10),
                                  (30, 40, 30)])
@pytest.mark.parametrize("omit_soft", [False, True])
def test_window_keys_kernel_matches_plain(dev, geom, omit_soft):
    b = torch.from_numpy(_window_buffer(sum(geom), 300_001)).to(dev)
    before = pack.window_keys_both.launches
    ok_k, fwd_k, rc_k = pack.window_keys_both(b, *geom, 2, 5, omit_soft)
    ok_p, fwd_p, rc_p = pack.window_keys_both_reference(b, *geom, 2, 5,
                                                        omit_soft)
    torch.cuda.synchronize()
    assert pack.window_keys_both.launches == before + 1
    assert torch.equal(ok_k, ok_p)
    assert bool(ok_p.any()) and not bool(ok_p.all())
    assert torch.equal(fwd_k[:, ok_p], fwd_p[:, ok_p])
    assert torch.equal(rc_k[:, ok_p], rc_p[:, ok_p])


@pytest.mark.parametrize("geom", [(1, 0, 0), (25, 1, 2), (30, 40, 30),
                                  (500, 24, 500)],
                         ids=["L1", "L28", "L100", "L1024"])
@pytest.mark.parametrize("n_win", [-3, 1, 15, 16, 17, 4095, 4096, 4097,
                                   300_001])
@pytest.mark.parametrize("omit_soft", [False, True])
def test_window_keys_both_modes_match_plain(dev, geom, n_win, omit_soft):
    """Both modes at L = 1 to 1024, P < L (n_win <= 0), and window counts
    at the edges of a thread's 16-window stretch and a block's 4,096; the
    table mode into a column slice of a wider table (row stride above
    2 n_win), the slice's neighbours untouched."""
    L = sum(geom)
    P = n_win + L - 1 if n_win > 0 else max(L + n_win, 0)
    buf = _window_buffer(L + n_win + 3, P)
    buf[:min(L, P)] = np.frombuffer(b"ACGT" * 256, np.uint8)[:min(L, P)]
    b = torch.from_numpy(buf).to(dev)
    nw = max(P - L + 1, 0)
    ok_k, fwd_k, rc_k = pack.window_keys_both(b, *geom, 2, 5, omit_soft)
    ok_p, fwd_p, rc_p = pack.window_keys_both_reference(b, *geom, 2, 5,
                                                        omit_soft)
    W = fwd_p.shape[0]
    wide = torch.full((W, 2 * nw + 5), 7, dtype=torch.int32, device=dev)
    before = pack.window_keys_table.launches
    view = wide[:, 2:2 + 2 * nw]
    got = pack.window_keys_table(b, 3, *geom, 5, omit_soft, out=view)
    want = pack.window_keys_table_reference(b, 3, *geom, 5, omit_soft)
    torch.cuda.synchronize()
    assert pack.window_keys_table.launches == before + 1
    assert ok_k.shape == (nw,) and fwd_k.shape == (W, nw)
    assert torch.equal(ok_k, ok_p)
    assert torch.equal(fwd_k[:, ok_p], fwd_p[:, ok_p])
    assert torch.equal(rc_k[:, ok_p], rc_p[:, ok_p])
    assert got is view
    assert torch.equal(got, want)
    assert bool((wide[:, :2] == 7).all())
    assert bool((wide[:, 2 + 2 * nw:] == 7).all())
    if nw:
        assert bool(ok_p[0])


@pytest.mark.parametrize("n", [1, 2, 2047, 2048, 2049, 1_000_003])
@pytest.mark.parametrize("n_files", [2, 3, 5])
@pytest.mark.parametrize("key", [(25, 1, 2, 2), (25, 1, 2, 4),
                                 (30, 40, 30, 2)],
                         ids=["spacer_2bit", "iupac_4bit", "amplicon"])
def test_survivor_scan_kernel_matches_plain(dev, n, n_files, key):
    """2-word spacer keys, and the wide keys of the prefilter paths (4
    words at 4-bit 25/1/2, 7 words at 30/40/30), whose flank and file
    masks fall in word 3."""
    rng = np.random.default_rng(n + n_files)
    layout = KeyLayout(*key, n_files)
    words = np.stack([rng.integers(0, 4, n).astype(np.uint32) << 28
                      for _ in range(layout.n_words)])
    fw, fsh = layout.file_word_shift()
    words[fw] &= ~np.uint32(layout.file_sentinel << fsh)
    ids = rng.integers(0, n_files, n).astype(np.uint32)
    ids[rng.random(n) < 0.05] = layout.file_sentinel
    words[fw] |= ids << fsh
    words = words[:, np.lexsort(tuple(words[::-1]))]
    valid = ((words[fw] >> np.uint32(fsh)) & np.uint32(layout.file_sentinel)
             ) != layout.file_sentinel
    w = torch.from_numpy(words.view(np.int32)).to(dev)
    v = torch.from_numpy(valid).to(dev)
    ff = layout.file_off + layout.file_bits
    got = scan.survivor_scan(w, v, layout.flank_bits, ff, n_files)
    want = scan.survivor_scan_reference(w, v, layout.flank_bits, ff, n_files)
    torch.cuda.synchronize()
    for g, r in zip(got, want):
        assert g.dtype == r.dtype and torch.equal(g, r)


def _sort_input(dist, V, n, rng):
    """uint32[V, n] rows: random words, all rows equal, few distinct values
    with top-bit words (heavy ties), random rows with all-ones sentinel
    rows mixed in, or rows that differ in one bit only."""
    if dist == "random":
        return rng.integers(0, 2**32, (V, n), dtype=np.uint64).astype(
            np.uint32)
    if dist == "equal":
        return np.full((V, n), 0x80000001, np.uint32)
    if dist == "ties":
        pool = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE,
                         0xFFFFFFFF], np.uint32)
        return pool[rng.integers(0, pool.size, (V, n))]
    if dist == "one_bit":
        words = np.full((V, n), 0x12345678, np.uint32)
        words[V // 2] |= (rng.random(n) < 0.5).astype(np.uint32) << 31
        return words
    words = rng.integers(0, 2**32, (V, n), dtype=np.uint64).astype(np.uint32)
    words[:, rng.random(n) < 0.2] = 0xFFFFFFFF
    return words


@pytest.mark.parametrize("V", [1, 2, 3, 4, 7, 9, 64])
@pytest.mark.parametrize("n", [0, 1, 2, 8191, 8192, 8193, 10_000_019])
@pytest.mark.parametrize("dist", ["random", "equal", "ties", "sentinels",
                                  "one_bit"])
def test_sort_words_kernel_matches_plain(dev, V, n, dist):
    """n at one row, a tile (8,192 rows) +- 1 and 10M + 19."""
    rng = np.random.default_rng(V * 7 + n)
    words = _sort_input(dist, V, n, rng)
    w = torch.from_numpy(words.view(np.int32)).to(dev)
    before = sort.sort_words.launches
    got = sort.sort_words(w)
    want = sort.sort_words_reference(w)
    torch.cuda.synchronize()
    assert sort.sort_words.launches == before + (n > 0)
    assert got.dtype == torch.int32 and got.shape == (V, n)
    assert torch.equal(got, want)
    assert torch.equal(w.cpu(), torch.from_numpy(words.view(np.int32)))


def _plan(words):
    """The sort's plan for uint32[V, n], from a numpy fold of the rows as
    the kernel's vary_kernel folds them."""
    sent = (words == 0xFFFFFFFF).all(axis=0)
    rest = words[:, ~sent]
    fold = ([int(np.bitwise_or.reduce(r)) for r in rest],
            [int(np.bitwise_or.reduce(~r)) for r in rest],
            int(sent.any()) | 2 * int((~sent).any()))
    return sort.sort_pass_plan(sort.varying_masks(*fold))


@pytest.mark.parametrize("passes", range(1, 9))
@pytest.mark.parametrize("sentinels", [False, True])
def test_sort_words_kernel_plans_of_1_to_8_passes(dev, passes, sentinels):
    """2-word rows whose varying bits fill ``passes`` digits of up to 9
    bits, straddling the word boundary.  With sentinel rows one bit fewer
    varies, and the sentinels' bit, the next one up, fills the last
    digit."""
    rng = np.random.default_rng(passes * 16 + sentinels)
    n = 1_000_003
    span = 9 * (passes - 1) + 1 - sentinels
    lo = min(20, 64 - span - sentinels)   # key bits [lo, lo + span)
    words = rng.integers(0, 2**32, (2, n), dtype=np.uint64).astype(np.uint32)
    for k in range(2):
        bits = [b for b in range(lo, lo + span)
                if 32 * (1 - k) <= b < 32 * (2 - k)]
        words[k] &= np.uint32(sum(1 << (b % 32) for b in bits))
    if sentinels:
        words[:, rng.random(n) < 0.1] = 0xFFFFFFFF
    assert len(_plan(words)) == passes
    w = torch.from_numpy(words.view(np.int32)).to(dev)
    got = sort.sort_words(w)
    torch.cuda.synchronize()
    assert torch.equal(got, sort.sort_words_reference(w))


@pytest.mark.parametrize("width", [1, 2, 5, 8, 9])
@pytest.mark.parametrize("V", [2, 3, 4, 7])
def test_sort_words_kernel_every_digit_width(dev, width, V):
    """Digits of each width the plan can take, in key mode (V <= 3) and
    index mode: every word varies in ``width`` bits, with sentinel rows
    (their bit is a digit of 1 bit)."""
    rng = np.random.default_rng(width * 10 + V)
    words = rng.integers(0, 2**32, (V, 300_007), dtype=np.uint64).astype(
        np.uint32) & np.uint32(((1 << width) - 1) << 3)
    words[:, rng.random(words.shape[1]) < 0.2] = 0xFFFFFFFF
    plan = _plan(words)
    assert {w for _, w in plan} == {width, 1}
    w = torch.from_numpy(words.view(np.int32)).to(dev)
    got = sort.sort_words(w)
    torch.cuda.synchronize()
    assert torch.equal(got, sort.sort_words_reference(w))


@pytest.mark.parametrize("n", [0, 1, 2, SCAN_TILE - 1, SCAN_TILE,
                               SCAN_TILE + 1, 3 * SCAN_TILE - 1,
                               3 * SCAN_TILE + 1])
def test_survivor_scan_kernel_takes_small_tables(dev, n):
    """n = 0 (the prefilter kept no row) returns empty outputs without a
    launch; n of 1, 2 and a whole number of tiles +- 1 launch, in both
    modes (one flank group: every tile but the last is open)."""
    w = torch.zeros((2, n), dtype=torch.int32, device=dev)
    v = torch.ones(n, dtype=torch.bool, device=dev)
    layout = KeyLayout(25, 1, 2, 2, 1)
    before = scan.survivor_scan.launches, scan.survivor_scan_layout.launches
    got = scan.survivor_scan(w, v, 54, 58, 1)
    got_l = scan.survivor_scan_layout(w, layout, 1)
    want = scan.survivor_scan_reference(w, v, 54, 58, 1)
    torch.cuda.synchronize()
    assert (scan.survivor_scan.launches, scan.survivor_scan_layout.launches
            ) == (before[0] + (n > 0), before[1] + (n > 0))
    for g, gl, r in zip(got, got_l, want):
        assert g.shape == (n,) and g.dtype == r.dtype and torch.equal(g, r)
        assert torch.equal(gl, r)


def _scan_both_modes(layout, w, v, n_files):
    """Both kernel modes vs the plain version on one table."""
    ff = layout.file_off + layout.file_bits
    got = scan.survivor_scan(w, v, layout.flank_bits, ff, n_files)
    got_l = scan.survivor_scan_layout(w, layout, n_files)
    want = scan.survivor_scan_reference(w, v, layout.flank_bits, ff, n_files)
    torch.cuda.synchronize()
    for g, gl, r in zip(got, got_l, want):
        assert g.dtype == r.dtype and torch.equal(g, r)
        assert gl.dtype == r.dtype and torch.equal(gl, r)
    return want


@pytest.mark.parametrize("n", [3 * SCAN_TILE + 1, 1_000_003, 10_000_019])
@pytest.mark.parametrize("key", [(25, 1, 2, 2), (25, 1, 2, 4),
                                 (30, 40, 30, 2)],
                         ids=["spacer_2bit", "iupac_4bit", "amplicon"])
def test_survivor_scan_short_groups_match_plain(dev, n, key):
    """Tables like the main path's: random keys whose flanks come from a
    pool of n / 4 values, so most groups hold a few rows, some span all
    five genomes, and almost no group is open at the look-ahead."""
    rng = np.random.default_rng(n)
    layout = KeyLayout(*key, 5)
    W = layout.n_words
    pool = rng.integers(0, 2**32, (W, n // 4 + 1), dtype=np.uint64).astype(
        np.uint32)
    words = pool[:, rng.integers(0, pool.shape[1], n)]
    full, rem = divmod(layout.flank_bits, 32)
    if rem:   # bits past the flank: random mids
        words[full] = ((words[full] & np.uint32((0xFFFFFFFF << (32 - rem))
                                                & 0xFFFFFFFF))
                       | (rng.integers(0, 2**32, n, dtype=np.uint64)
                          .astype(np.uint32)
                          & np.uint32((1 << (32 - rem)) - 1)))
    fw, fsh = layout.file_word_shift()
    words[fw] &= ~np.uint32(layout.file_sentinel << fsh)
    ids = rng.integers(0, 5, n).astype(np.uint32)
    ids[rng.random(n) < 0.05] = layout.file_sentinel
    words[fw] |= ids << fsh
    words = words[:, np.lexsort(tuple(words[::-1]))]
    valid = ((words[fw] >> np.uint32(fsh)) & np.uint32(layout.file_sentinel)
             ) != layout.file_sentinel
    want = _scan_both_modes(layout,
                            torch.from_numpy(words.view(np.int32)).to(dev),
                            torch.from_numpy(valid).to(dev), 5)
    assert bool(want[0].any())


@pytest.mark.parametrize("name", [c[0] for c in edge_tables(SCAN_TILE,
                                                            SCAN_AHEAD)])
def test_survivor_scan_edge_tables_match_plain(dev, name):
    """Groups and runs ending on tile edges and at the end of the
    look-ahead (open or closed), one group through every tile, every row
    its own group, no valid row: at the kernel's own tile and look-ahead,
    both modes."""
    layout, words, valid, n_files = edge_table(name, SCAN_TILE, SCAN_AHEAD,
                                               KeyLayout)
    _scan_both_modes(layout, torch.from_numpy(words.view(np.int32)).to(dev),
                     torch.from_numpy(valid).to(dev), n_files)


@pytest.mark.parametrize("V", [1, 2, 3, 7, 9])
@pytest.mark.parametrize("na,nb", [(0, 0), (0, 1), (1, 0), (1, 1), (0, 5000),
                                   (4097, 0), (2047, 2049), (1, 300_001),
                                   (1_000_003, 333_331)])
@pytest.mark.parametrize("dist", ["random", "ties", "sentinels"])
def test_merge_kernel_matches_plain(dev, V, na, nb, dist):
    """Empty and one-row runs, tiles that split runs unevenly, heavy ties
    across the runs and all-ones rows."""
    rng = np.random.default_rng(V * 1000 + na + nb)
    runs = []
    for n in (na, nb):
        w = torch.from_numpy(_sort_input(dist, V, n, rng).view(np.int32))
        runs.append(sort.sort_words_reference(w.to(dev)))
    before = merge.merge_sorted_words.launches
    got = merge.merge_sorted_words(*runs)
    want = merge.merge_sorted_words_reference(*runs)
    torch.cuda.synchronize()
    assert merge.merge_sorted_words.launches == before + (na + nb > 0)
    assert got.dtype == torch.int32 and got.shape == (V, na + nb)
    assert torch.equal(got, want)


def test_merge_kernel_takes_every_width(dev):
    """1 to 64 words: the tile shrinks with the width."""
    rng = np.random.default_rng(64)
    for V in (12, 13, 24, 25, 48, 49, 64):
        a, b = (sort.sort_words_reference(torch.from_numpy(
            _sort_input("ties", V, n, rng).view(np.int32)).to(dev))
            for n in (5003, 7919))
        got = merge.merge_sorted_words(a, b)
        torch.cuda.synchronize()
        assert torch.equal(got, merge.merge_sorted_words_reference(a, b)), V


def _write_genomes(tmp_path, geom, n_files, size, seed):
    rng = np.random.default_rng(seed)
    L = sum(geom)
    shared = ["".join(rng.choice(list("ACGT"), size=L)) for _ in range(3)]
    paths = []
    for f in range(n_files):
        seq = list("".join(rng.choice(list("ACGTNacgt"), size=size,
                                      p=[0.22] * 4 + [0.024] * 5)))
        for i, p in enumerate(shared):
            pos = (i + 1) * size // 4
            seq[pos:pos + L] = p
        path = tmp_path / f"g{f}.fasta"
        path.write_text(f">g{f}\n" + "".join(seq) + "\n")
        paths.append(str(path))
    return paths


@pytest.mark.parametrize("geom", [(25, 1, 2), (30, 40, 30), (4, 1, 3)])
def test_staged_path_cuda_matches_cpu(dev, tmp_path, monkeypatch, geom):
    """The out-of-core path with tiny chunks and passes: equal groups on
    the card and on the CPU, and the kernels launched."""
    from krisp_tpu_torch.engine.pipeline import KmerGeometry, run_pipeline
    monkeypatch.setenv("KRISP_TPU_CHUNK_BASES", "1500")
    monkeypatch.setenv("KRISP_TPU_GLOBAL_ROWS", "2000")
    paths = _write_genomes(tmp_path, geom, 4, 6000, sum(geom))
    got = {}
    for d in (dev, "cpu"):
        before = (sort.sort_words.launches,
                  scan.survivor_scan_layout.launches,
                  pack.window_keys_table.launches)
        groups = run_pipeline(paths[:2], paths[2:], KmerGeometry(*geom),
                              ingroup_filter=False,
                              workdir=str(tmp_path / f"wd_{d}"), device=d)
        after = (sort.sort_words.launches,
                 scan.survivor_scan_layout.launches,
                 pack.window_keys_table.launches)
        if d != "cpu":
            assert all(a > b for a, b in zip(after, before))
        got[str(d)] = [(g.left, g.right, [(a.mid, a.label_counts)
                                          for a in g.amplicons])
                       for g in groups]
    assert got[str(dev)] == got["cpu"] and len(got["cpu"]) >= 3
