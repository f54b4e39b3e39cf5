"""The port's out-of-core path (chunked per-genome tables, the on-disk table
cache, the range-partitioned global stage) vs krisp_tpu's on the CPU, stage
by stage and end to end.  Integer outputs: the tolerance is 0."""

import pytest

pytest.importorskip("jax")

import tempfile  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from krisp_tpu import dna  # noqa: E402
from krisp_tpu.engine import bigscale as JB  # noqa: E402
from krisp_tpu.engine import pipeline as JP  # noqa: E402
from krisp_tpu.engine import render  # noqa: E402
from krisp_tpu.metrics import GLOBAL as JAX_METRICS  # noqa: E402
from krisp_tpu.ops import intersect as JI  # noqa: E402
from krisp_tpu.ops.encode import KeyLayout as JKeyLayout  # noqa: E402
from krisp_tpu_torch.convert import keys_from_numpy, keys_to_numpy  # noqa: E402
from krisp_tpu_torch.engine import bigscale as TB  # noqa: E402
from krisp_tpu_torch.engine import pipeline as TP  # noqa: E402
from krisp_tpu_torch.metrics import GLOBAL as PORT_METRICS  # noqa: E402
from krisp_tpu_torch.ops import intersect as TI  # noqa: E402
from krisp_tpu_torch.ops.encode import KeyLayout  # noqa: E402
from krisp_tpu_torch.ops.pack import _codes_and_valid  # noqa: E402


def _u32(t):
    return keys_to_numpy(t)


def _genomes(tmp_path, rng, geom, n_files, size, alphabet="ACGTNacgt",
             tag="g"):
    """Random genomes (N and lower-case bases) with 4 planted flank pairs;
    the mid differs between genomes 0-1 and the rest."""
    left, mid, right = geom
    L = sum(geom)
    flanks = [("".join(rng.choice(list("ACGT"), size=left)),
               "".join(rng.choice(list("ACGT"), size=right)))
              for _ in range(4)]
    k = len(alphabet) - 4
    p = [0.88 / 4] * 4 + [0.12 / k] * k
    paths = []
    for f in range(n_files):
        seq = list("".join(rng.choice(list(alphabet), size=size, p=p)))
        for i, (fl, fr) in enumerate(flanks):
            pos = (i + 1) * size // (len(flanks) + 2)
            seq[pos:pos + L] = fl + ("A" if f < 2 else "C") * mid + fr
        path = tmp_path / f"{tag}{f}.fasta"
        path.write_text(f">{tag}{f}\n" + "".join(seq) + "\n")
        paths.append(str(path))
    return paths


def _render(groups):
    return ("".join(render.render_csv(g) + "\n" for g in groups),
            "".join(render.render_alignment(g) + "\n" for g in groups))


def _parts(rng, layout, n_files, sizes, key_bits=20):
    """Per-genome sorted sub-runs (host uint32 tables, genome id OR'd in):
    few distinct flanks, so flank groups span runs and genomes."""
    fw, fsh = layout.file_word_shift()
    parts = []
    for f, runs in zip(range(n_files), sizes):
        ws, cs, offsets = [], [], [0]
        for n in runs:
            w = np.zeros((layout.n_words, n), np.uint32)
            w[0] = rng.integers(0, 1 << key_bits, n).astype(np.uint32) << (
                32 - key_bits)
            for i in range(1, layout.n_words):
                w[i] = rng.integers(0, 3, n).astype(np.uint32) << 28
            w[fw] &= ~np.uint32(layout.file_sentinel << fsh)
            w = w[:, np.lexsort(tuple(w[::-1]))]
            if n:   # distinct rows, as a deduplicated chunk holds them
                w = w[:, np.concatenate([[True],
                                         (w[:, 1:] != w[:, :-1]).any(0)])]
            ws.append(w)
            cs.append(rng.integers(1, 5, w.shape[1]).astype(np.uint32))
            offsets.append(offsets[-1] + w.shape[1])
        words = np.concatenate(ws, axis=1)
        words[fw] |= np.uint32(f << fsh)
        parts.append((words, np.concatenate(cs), np.array(offsets, np.int64)))
    return parts


# --- the copied helpers, pinned equal --------------------------------------

def test_bigscale_helpers_equal_jax():
    rng = np.random.default_rng(1)
    layout = KeyLayout(8, 1, 5, 2, 3)
    parts = _parts(rng, layout, 3, [(400, 1, 57), (0, 300), (250,)])
    for shift, budget in ((16, 90), (24, 300), (28, 10_000)):
        nb = 1 << (32 - shift)
        got = TB._prefix_ranges(parts, shift, nb, budget)
        assert got == JB._prefix_ranges(parts, shift, nb, budget)
        assert len(got) > 1 or budget == 10_000
        for blo, bhi in got:
            bounds = TB._range_bounds(parts, shift, blo, bhi)
            assert bounds == JB._range_bounds(parts, shift, blo, bhi)
            for a, b in zip(TB._slice_range(parts, bounds),
                            JB._slice_range(parts, bounds)):
                assert (a is None and b is None) or np.array_equal(a, b)


@pytest.mark.parametrize("env", [{}, {"KRISP_TPU_GLOBAL_ROWS": "12345"},
                                 {"KRISP_TPU_GLOBAL_BYTES": "1000000"},
                                 {"KRISP_TPU_GLOBAL_BYTES": "1000"},
                                 {"KRISP_TPU_GLOBAL_ROWS": "7",
                                  "KRISP_TPU_GLOBAL_BYTES": "1000000"}])
def test_row_budget_for_equals_jax(monkeypatch, env):
    monkeypatch.delenv("KRISP_TPU_GLOBAL_ROWS", raising=False)
    monkeypatch.delenv("KRISP_TPU_GLOBAL_BYTES", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for geom, bits in (((25, 1, 2), 2), ((30, 40, 30), 2), ((25, 1, 2), 4)):
        got = TB.row_budget_for(KeyLayout(*geom, bits, 5))
        assert got == JB.row_budget_for(JKeyLayout(*geom, bits, 5))
    if not env:
        assert got == (2 << 30) // (4 * 5)


# --- device stages -----------------------------------------------------------

@pytest.mark.parametrize("n_valid", [0, 1, 700, 1000])
def test_dedup_sorted_matches_jax(n_valid):
    rng = np.random.default_rng(n_valid)
    n = 1000
    w = rng.integers(0, 4, (2, n)).astype(np.uint32) << 30
    w = w[:, np.lexsort(tuple(w[::-1]))]
    w[:, n_valid:] = 0xFFFFFFFF
    got_w, got_c = TI.dedup_sorted(keys_from_numpy(w, "cpu"), n_valid)
    want_w, want_c = JI.dedup_sorted(list(w), n_valid)
    np.testing.assert_array_equal(_u32(got_w), np.stack(want_w))
    np.testing.assert_array_equal(_u32(got_c), np.asarray(want_c))
    assert int(got_c.sum()) == n_valid


def _weighted_table(rng, layout, n_files, n):
    """Sorted KeyLayout rows with duplicates across genomes, sentinel rows,
    and weights: 1-4, with one run whose weights sum past 2**32."""
    fw, fsh = layout.file_word_shift()
    w = np.zeros((layout.n_words, n), np.uint32)
    w[0] = rng.integers(0, 6, n).astype(np.uint32) << 26
    w[fw] &= ~np.uint32(layout.file_sentinel << fsh)
    ids = rng.integers(0, n_files, n).astype(np.uint32)
    w[fw] |= ids << fsh
    if layout.n_words > 1:
        w[-1] |= rng.integers(0, 2, n).astype(np.uint32)
    w[:, rng.random(n) < 0.05] = 0xFFFFFFFF
    w = w[:, np.lexsort(tuple(w[::-1]))]
    sent = (w == 0xFFFFFFFF).all(0)
    weights = rng.integers(1, 5, n).astype(np.uint32)
    # the first three rows of the first run weigh 2**31 - 1 each
    weights[:3] = 0x7FFFFFFF
    w[:, 1:3] = w[:, :1]
    weights[sent] = 0
    return w, weights


def _run_sum(w, weights, row):
    """The exact total weight of the rows equal to ``w[:, row]``."""
    same = (w == w[:, row:row + 1]).all(0)
    return int(weights[same].astype(np.int64).sum())


@pytest.mark.parametrize("n_files", [2, 3])
def test_weighted_marking_matches_jax(n_files):
    rng = np.random.default_rng(n_files)
    layout = KeyLayout(4, 1, 3, 2, n_files)
    w, weights = _weighted_table(rng, layout, n_files, 3000)
    keep, counts, gid = TI.survivor_mark_weighted(
        keys_from_numpy(w, "cpu"), layout, n_files,
        keys_from_numpy(weights, "cpu"))
    j_keep, j_counts, j_gid = JI.survivor_mark_bits(
        list(w), JKeyLayout(4, 1, 3, 2, n_files), n_files, weights=weights)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(j_keep))
    np.testing.assert_array_equal(gid.numpy(), np.asarray(j_gid))
    np.testing.assert_array_equal(_u32(counts), np.asarray(j_counts))
    # the first run weighs more than 2**32 and its count wraps
    heavy = _run_sum(w, weights, 0)
    assert heavy > 2**32 and int(_u32(counts)[0]) == heavy % 2**32
    assert bool(keep.any())


@pytest.mark.parametrize("geom,bits", [((4, 1, 3), 2), ((30, 40, 30), 2),
                                       ((25, 1, 2), 4)])
def test_global_intersect_bits_matches_jax(geom, bits):
    """Unsorted rows with weights > 1 and a run past 2**32; the port sorts
    the counts as a trailing word, so counts compare at the kept (head)
    rows, which are all it returns."""
    rng = np.random.default_rng(sum(geom) + bits)
    n_files = 3
    layout = KeyLayout(*geom, bits, n_files)
    w, weights = _weighted_table(rng, layout, n_files, 4000)
    heavy_key, heavy = w[:, 0].copy(), _run_sum(w, weights, 0)
    perm = rng.permutation(w.shape[1])
    w, weights = w[:, perm], weights[perm]
    got_w, got_c, got_g = TI.global_intersect_bits(
        keys_from_numpy(w, "cpu"), keys_from_numpy(weights, "cpu"), layout,
        n_files)
    jw, jc, jg, nk = JI.global_intersect_bits(
        tuple(w), weights, JKeyLayout(*geom, bits, n_files), n_files=n_files,
        cap=1 << 13)
    nk = int(nk)
    assert nk > 0 and got_w.shape == (layout.n_words, nk)
    np.testing.assert_array_equal(_u32(got_w), np.asarray(jw)[:, :nk])
    np.testing.assert_array_equal(_u32(got_c), np.asarray(jc)[:nk])
    np.testing.assert_array_equal(got_g.numpy(), np.asarray(jg)[:nk])
    # the heaviest run is kept, and its count wraps past 2**32
    (row,) = np.nonzero((_u32(got_w) == heavy_key[:, None]).all(0))[0]
    assert heavy > 2**32 and int(_u32(got_c)[row]) == heavy % 2**32


@pytest.mark.parametrize("omit_soft", [False, True])
def test_window_kernel_validity_equals_table(omit_soft):
    """The window-key kernel's arithmetic validity (its plain version) on
    every byte a 2-bit input holds equals the validity table krisp_tpu's
    genome_unique_table reads."""
    admitted = np.frombuffer(b"ACGTNacgtn\0", np.uint8)
    assert dna.choose_bits(admitted) == 2
    _, valid = _codes_and_valid(torch.from_numpy(admitted.copy()), omit_soft)
    table = dna.base_validity_table(2, disallow="Nn", omit_soft=omit_soft)
    np.testing.assert_array_equal(valid.numpy(), table[admitted])


@pytest.mark.parametrize("geom,alphabet,omit_soft",
                         [((4, 1, 3), "ACGTNnacgt", False),
                          ((4, 1, 3), "ACGTNnacgt", True),
                          ((10, 4, 10), "ACGTNnacgt", True),
                          ((5, 1, 3), "ACGTRYNacgt", False),
                          ((5, 1, 3), "ACGTRYNacgt", True)])
def test_genome_unique_table_matches_jax(geom, alphabet, omit_soft):
    """2-bit (lower-case runs, N and n) through the window-key kernel's
    plain version, and 4-bit through window_keys_bits.  krisp_tpu pads the
    buffer to a bucket, which adds sentinel rows only: the rows with a
    count are equal."""
    rng = np.random.default_rng(sum(geom) + len(alphabet))
    k = len(alphabet) - 4
    buf = rng.choice(np.frombuffer(alphabet.encode(), np.uint8), size=3000,
                     p=[0.97 / 4] * 4 + [0.03 / k] * k)
    for s in rng.integers(0, 2900, 12):        # soft-masked runs
        buf[s:s + rng.integers(5, 60)] |= 0x20
    buf[rng.integers(0, 3000, 20)] = 0         # record separators
    buf[100:300] = buf[1000:1200]              # repeats: counts > 1
    bits = dna.choose_bits(buf)
    assert bits == (4 if "R" in alphabet else 2)
    g = TP.KmerGeometry(*geom)
    words, counts = TP.genome_unique_table(torch.from_numpy(buf), g, bits,
                                           omit_soft, n_files=3)
    padded = np.zeros(4096, np.uint8)
    padded[:buf.size] = buf
    jw, jc = JP.genome_unique_table(padded, JP.KmerGeometry(*geom), bits,
                                    omit_soft, 3)
    jw, jc = np.asarray(jw), np.asarray(jc)
    n = counts.numel()
    assert n == 2 * (buf.size - sum(geom) + 1)
    assert int((jc > 0).sum()) > 0 and int((jc > 1).sum()) > 0
    # the padding's windows are invalid and sort last: the port's table is
    # krisp_tpu's up to its own length
    np.testing.assert_array_equal(_u32(words), jw[:, :n])
    np.testing.assert_array_equal(_u32(counts), jc[:n])
    assert (jw[:, n:] == 0xFFFFFFFF).all() and not jc[n:].any()


@pytest.mark.parametrize("bits_alphabet", ["ACGTNacgt", "ACGTRYNacgt"])
@pytest.mark.parametrize("chunk", [700, 1999, 100_000])
def test_genome_table_chunked_matches_jax(tmp_path, bits_alphabet, chunk):
    rng = np.random.default_rng(chunk)
    geom = (6, 2, 5)
    (path,) = _genomes(tmp_path, rng, geom, 1, 5000, bits_alphabet)
    bits = 4 if "R" in bits_alphabet else 2
    got = TP._genome_table_chunked(path, TP.KmerGeometry(*geom), bits, True,
                                   chunk, n_files=4, device="cpu")
    want = JP._genome_table_chunked(path, JP.KmerGeometry(*geom), bits, True,
                                    chunk, n_files=4)
    assert got[0].dtype == np.uint32 and got[1].dtype == np.uint32
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[2].size == -(-5000 // chunk) + 1


@pytest.mark.parametrize("budget", [None, 300, 37])
def test_partitioned_global_intersect_matches_jax(budget):
    """Words, counts and per-pass offset gids equal krisp_tpu's staged
    result."""
    rng = np.random.default_rng(budget or 0)
    n_files = 3
    layout = KeyLayout(6, 1, 4, 2, n_files)
    parts = _parts(rng, layout, n_files, [(300, 250, 9), (400,), (120, 330)],
                   key_bits=9)
    stats_t, stats_j = {}, {}
    got = TB.partitioned_global_intersect(parts, layout, n_files,
                                          row_budget=budget, stats=stats_t,
                                          device="cpu")
    want = JB.partitioned_global_intersect(
        parts, JKeyLayout(6, 1, 4, 2, n_files), n_files=n_files,
        row_budget=budget, stats=stats_j)
    assert stats_t == stats_j
    assert stats_t["global_passes"] > (1 if budget else 0)
    assert got[0].shape[0] > 0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_partitioned_global_intersect_empty():
    layout = KeyLayout(25, 1, 2, 2, 5)
    parts = [(np.zeros((2, 0), np.uint32), np.zeros(0, np.uint32),
              np.zeros(1, np.int64))]
    w, c, g = TB.partitioned_global_intersect(parts, layout, 5,
                                              device="cpu")
    assert w.shape == (0, 2) and c.size == 0 and g.size == 0


# --- run_pipeline end to end -------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_fuzz_staged_matches_jax(seed, tmp_path, monkeypatch):
    """Random geometry, genome count, softmask policy, alphabet, chunk size
    and pass budget: the port's staged run renders the bytes of
    krisp_tpu's staged run and of its fused run."""
    rng = np.random.default_rng(5000 + seed)
    geom = (int(rng.integers(3, 12)), int(rng.integers(0, 4)),
            int(rng.integers(2, 10)))
    n_files = int(rng.integers(2, 5))
    omit_soft = bool(rng.integers(0, 2))
    alphabet = "ACGTNacgt"
    if seed == 3:
        # 4-bit keys; long flanks keep random IUPAC windows from surviving
        # (the consensus of krisp_tpu's ingroup filter refuses some mixes)
        geom, alphabet = (9, 1, 8), "ACGTRYNacgt"
    paths = _genomes(tmp_path, rng, geom, n_files,
                     int(rng.integers(3000, 6000)), alphabet)
    ins, outs = paths[:2], paths[2:]
    fused = JP.run_pipeline(ins, outs, JP.KmerGeometry(*geom),
                            omit_soft=omit_soft)
    monkeypatch.setenv("KRISP_TPU_CHUNK_BASES",
                       str(int(rng.integers(700, 2000))))
    monkeypatch.setenv("KRISP_TPU_GLOBAL_ROWS",
                       str(int(rng.integers(500, 3000))))
    staged = JP.run_pipeline(ins, outs, JP.KmerGeometry(*geom),
                             omit_soft=omit_soft,
                             workdir=str(tmp_path / "jax_wd"))
    PORT_METRICS.reset()
    got = TP.run_pipeline(ins, outs, TP.KmerGeometry(*geom),
                          omit_soft=omit_soft,
                          workdir=str(tmp_path / "port_wd"), device="cpu")
    assert PORT_METRICS.stages["global_pass"].calls > 1
    assert fused, "fuzz case produced no groups"
    assert _render(got) == _render(staged) == _render(fused)


def test_table_cache_shared_both_ways(tmp_path, monkeypatch):
    """Cache files written by either package load in the other (no table
    is rebuilt) and give the same groups."""
    rng = np.random.default_rng(77)
    geom = (7, 1, 4)
    paths = _genomes(tmp_path, rng, geom, 3, 4000)
    monkeypatch.setenv("KRISP_TPU_CHUNK_BASES", "1500")
    ins, outs = paths[:2], paths[2:]
    want = _render(JP.run_pipeline(ins, outs, JP.KmerGeometry(*geom)))
    for writer in ("jax", "port"):
        wd = tmp_path / f"wd_{writer}"
        if writer == "jax":
            JP.run_pipeline(ins, outs, JP.KmerGeometry(*geom), workdir=str(wd))
        else:
            TP.run_pipeline(ins, outs, TP.KmerGeometry(*geom),
                            workdir=str(wd), device="cpu")
        files = sorted(p.name for p in wd.iterdir())
        assert len(files) == 3
        PORT_METRICS.reset()
        JAX_METRICS.reset()
        got_port = TP.run_pipeline(ins, outs, TP.KmerGeometry(*geom),
                                   workdir=str(wd), device="cpu")
        got_jax = JP.run_pipeline(ins, outs, JP.KmerGeometry(*geom),
                                  workdir=str(wd))
        assert "extract+sort" not in PORT_METRICS.stages   # all cache hits
        assert "extract+sort" not in JAX_METRICS.stages
        assert sorted(p.name for p in wd.iterdir()) == files
        assert _render(got_port) == _render(got_jax) == want


def test_budget_routes_both_packages_staged(tmp_path, monkeypatch):
    """Step 0: the port reads KRISP_TPU_HBM_BUDGET at call time as
    krisp_tpu does; a tiny budget sends the same tiny input down both
    staged paths, and the port's output equals krisp_tpu's fused output."""
    rng = np.random.default_rng(3)
    geom = (25, 1, 2)
    paths = _genomes(tmp_path, rng, geom, 3, 3000)
    ins, outs = paths[:2], paths[2:]
    fused = _render(JP.run_pipeline(ins, outs, JP.KmerGeometry(*geom)))
    tmp = tmp_path / "tmp"
    tmp.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(tmp))
    monkeypatch.setenv("KRISP_TPU_HBM_BUDGET", "100000")
    JAX_METRICS.reset()
    PORT_METRICS.reset()
    staged_jax = _render(JP.run_pipeline(ins, outs, JP.KmerGeometry(*geom)))
    got = _render(TP.run_pipeline(ins, outs, TP.KmerGeometry(*geom),
                                  device="cpu"))
    assert "intersect" in JAX_METRICS.stages
    assert "intersect" in PORT_METRICS.stages
    assert "global_pass" in PORT_METRICS.stages
    assert got == staged_jax == fused
    # krisp_tpu leaves its temporary table directory behind; the port not
    assert len(list(tmp.glob("krisp_tpu_tables_*"))) == 1
    # a budget above the input keeps the port on its fused path
    monkeypatch.setenv("KRISP_TPU_HBM_BUDGET", str(1 << 40))
    PORT_METRICS.reset()
    assert _render(TP.run_pipeline(ins, outs, TP.KmerGeometry(*geom),
                                   device="cpu")) == fused
    assert "intersect" not in PORT_METRICS.stages
    assert "pull" in PORT_METRICS.stages


def test_temporary_workdir_is_removed(tmp_path, monkeypatch):
    """The directory the budget route creates is removed when the run ends,
    also when the run fails."""
    rng = np.random.default_rng(4)
    paths = _genomes(tmp_path, rng, (4, 1, 3), 2, 2000)
    tmp = tmp_path / "tmp"
    tmp.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(tmp))
    monkeypatch.setenv("KRISP_TPU_HBM_BUDGET", "1")
    made = []
    real_mkdtemp = tempfile.mkdtemp

    def spy(*args, **kwargs):
        made.append(real_mkdtemp(*args, **kwargs))
        return made[-1]
    monkeypatch.setattr(tempfile, "mkdtemp", spy)
    TP.run_pipeline(paths[:1], paths[1:], TP.KmerGeometry(4, 1, 3),
                    device="cpu")
    assert len(made) == 1 and "krisp_tpu_tables_" in made[0]
    assert list(tmp.iterdir()) == []

    def boom(*args, **kwargs):
        raise RuntimeError("pass failed")
    monkeypatch.setattr(TP, "partitioned_global_intersect", boom)
    with pytest.raises(RuntimeError, match="pass failed"):
        TP.run_pipeline(paths[:1], paths[1:], TP.KmerGeometry(4, 1, 3),
                        device="cpu")
    assert len(made) == 2 and list(tmp.iterdir()) == []
