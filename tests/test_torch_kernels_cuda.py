"""The CUDA kernels vs their plain PyTorch versions on the card.  Needs an
NVIDIA GPU and nvcc; skipped elsewhere.  Integer outputs: the tolerance
is 0.  Run on the card with ``python -m pytest tests/test_torch_kernels_cuda.py``."""

import numpy as np
import pytest
import torch

from krisp_tpu_torch.ops import pack, scan, sort
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
