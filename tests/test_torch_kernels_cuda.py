"""The CUDA kernels vs their plain PyTorch versions on the card.  Needs an
NVIDIA GPU and nvcc; skipped elsewhere.  Integer outputs: the tolerance
is 0.  Run on the card with ``python -m pytest tests/test_torch_kernels_cuda.py``."""

import numpy as np
import pytest
import torch

from krisp_tpu_torch.ops import merge, pack, scan, sort
from krisp_tpu_torch.ops.encode import KeyLayout

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("geom", [(25, 1, 2), (4, 1, 3), (10, 4, 10),
                                  (30, 40, 30)])
@pytest.mark.parametrize("omit_soft", [False, True])
def test_window_keys_kernel_matches_plain(dev, geom, omit_soft):
    rng = np.random.default_rng(sum(geom))
    # rare N and lower case, so that L = 100 under omit_soft keeps windows
    p = [0.245] * 4 + [0.004] * 5
    buf = rng.choice(np.frombuffer(b"ACGTNacgt", np.uint8), size=300_001, p=p)
    b = torch.from_numpy(buf).to(dev)
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
    with top-bit words (heavy ties), or random rows with all-ones sentinel
    rows mixed in."""
    if dist == "random":
        return rng.integers(0, 2**32, (V, n), dtype=np.uint64).astype(
            np.uint32)
    if dist == "equal":
        return np.full((V, n), 0x80000001, np.uint32)
    if dist == "ties":
        pool = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE,
                         0xFFFFFFFF], np.uint32)
        return pool[rng.integers(0, pool.size, (V, n))]
    words = rng.integers(0, 2**32, (V, n), dtype=np.uint64).astype(np.uint32)
    words[:, rng.random(n) < 0.2] = 0xFFFFFFFF
    return words


@pytest.mark.parametrize("V", [1, 2, 3, 4, 7, 13])
@pytest.mark.parametrize("n", [0, 1, 2, 4095, 4096, 4097, 1_000_003])
@pytest.mark.parametrize("dist", ["random", "equal", "ties", "sentinels"])
def test_sort_words_kernel_matches_plain(dev, V, n, dist):
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


@pytest.mark.parametrize("n", [0, 1, 2047, 2048, 2049])
def test_survivor_scan_kernel_takes_small_tables(dev, n):
    """n = 0 (the prefilter kept no row) returns empty outputs without a
    launch; small n launches."""
    w = torch.zeros((2, n), dtype=torch.int32, device=dev)
    v = torch.ones(n, dtype=torch.bool, device=dev)
    before = scan.survivor_scan.launches
    got = scan.survivor_scan(w, v, 54, 58, 1)
    want = scan.survivor_scan_reference(w, v, 54, 58, 1)
    torch.cuda.synchronize()
    assert scan.survivor_scan.launches == before + (n > 0)
    for g, r in zip(got, want):
        assert g.shape == (n,) and g.dtype == r.dtype and torch.equal(g, r)


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
        before = (sort.sort_words.launches, scan.survivor_scan.launches,
                  pack.window_keys_both.launches)
        groups = run_pipeline(paths[:2], paths[2:], KmerGeometry(*geom),
                              ingroup_filter=False,
                              workdir=str(tmp_path / f"wd_{d}"), device=d)
        after = (sort.sort_words.launches, scan.survivor_scan.launches,
                 pack.window_keys_both.launches)
        if d != "cpu":
            assert all(a > b for a, b in zip(after, before))
        got[str(d)] = [(g.left, g.right, [(a.mid, a.label_counts)
                                          for a in g.amplicons])
                       for g in groups]
    assert got[str(dev)] == got["cpu"] and len(got["cpu"]) >= 3
