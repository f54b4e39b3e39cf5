"""The port's plain survivor scan vs krisp_tpu's Pallas survivor scan
(interpret mode) and survivor_mark_bits.  Integer outputs: the tolerance
is 0."""

import re
from pathlib import Path

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
from torch_scan_tables import (  # noqa: E402
    edge_table, edge_tables, grouped_table, layout_for)


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


def test_layout_mode_equals_valid_array_call():
    """The layout mode's plain version is the valid-array call on
    ``valid_rows``; the CPU wrappers of both modes agree and launch
    nothing."""
    layout, words, valid = _table(11, 5000, 5, (25, 1, 2))
    w = keys_from_numpy(words, "cpu")
    np.testing.assert_array_equal(TS.valid_rows(w, layout).numpy(), valid)
    before = (TS.survivor_scan.launches, TS.survivor_scan_layout.launches)
    got = TS.survivor_scan_layout(w, layout, 5)
    want = TS.survivor_scan(w, TS.valid_rows(w, layout), layout.flank_bits,
                            layout.file_off + layout.file_bits, 5)
    for g, r in zip(got, want):
        assert g.dtype == r.dtype and torch.equal(g, r)
    assert (TS.survivor_scan.launches,
            TS.survivor_scan_layout.launches) == before


# --- a line-by-line emulation of csrc/survivor_scan.cu -------------------
#
# scan_kernel and patch_kernel at a small tile, look-ahead and bitmap word,
# with the status words packed as the kernel packs them, tiles run in waves
# (each wave's tiles publish before any of them looks back, so look-backs
# walk over published-but-not-combined words) and look-back windows of a
# few lanes.  The kernel's own sizes are read from its source.

_SRC = (Path(TS.__file__).resolve().parents[1] / "csrc"
        / "survivor_scan.cu").read_text()


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", _SRC).group(1))


_FIELD = 0x7FFFFFFF
_OWN, _INCL = 1 << 62, 2 << 62
_DONE, _HAS_HEAD = 1 << 63, 1 << 62


def _fwd_pack(kind, v):
    assert 0 <= v[0] <= _FIELD and 0 <= v[1] <= _FIELD
    return kind | v[0] << 31 | v[1]


def _fwd_unpack(w):
    return (w >> 31) & _FIELD, w & _FIELD


def _fwd_combine(earlier, later):
    return (earlier[0] + later[0],
            later[1] if later[0] else earlier[1] + later[1])


def _rev_pack(done, v):
    assert 0 <= v[1] <= _FIELD and 0 < v[2] + 1 <= _FIELD
    return ((_DONE if done else 0) | (_HAS_HEAD if v[0] else 0) | v[1] << 31
            | (v[2] + 1))


def _rev_unpack(w):
    return bool(w & _HAS_HEAD), (w >> 31) & _FIELD, (w & _FIELD) - 1


def _rev_combine(near, far):
    return (near[0] or far[0], near[1] if near[0] else near[1] + far[1],
            min(near[2], far[2]))


def _popc(x):
    return bin(x).count("1")


def _ffs0(x):      # __ffs(x) - 1
    return (x & -x).bit_length() - 1


def _msb(x):       # 31 - __clz(x) for 32-bit words
    return x.bit_length() - 1


def _prefix_mask(w, n_bits):
    full, rem = divmod(n_bits, 32)
    if w < full:
        return 0xFFFFFFFF
    if w == full and rem:
        return (0xFFFFFFFF << (32 - rem)) & 0xFFFFFFFF
    return 0


def _tree(xs, op):
    """The warp's shuffle-down reduction: lane l combines lane l + d."""
    d = 1
    while d < len(xs):
        xs = [op(xs[i], xs[i + d]) if i + d < len(xs) else xs[i]
              for i in range(len(xs))]
        d *= 2
    return xs[0]


class _Emulation:
    def __init__(self, tile, ahead, word, warps, scan_lanes, lanes, wave):
        self.T, self.B = tile, word
        self.span = tile + ahead
        self.mw, self.tw = self.span // word, tile // word
        assert self.span % word == 0 and self.mw % warps == 0
        self.warps, self.ww = warps, self.mw // warps
        self.scan_lanes, self.lanes, self.wave = scan_lanes, lanes, wave

    # scan_kernel, step 1: flags and bitmaps
    def _maps(self, s, words, valid, field, flank_bits, ff_bits):
        W, n = words.shape
        B, ww = self.B, self.ww
        lo, hi = max(s - 1, 0), min(n, s + self.span)
        maps = {k: [0] * self.mw for k in ("head", "x", "full", "kept")}
        for warp in range(self.warps):
            for lane in range(B):
                rows = [s + B * (warp * ww + k) + lane for k in range(ww)]
                any_, ff, fl, ok = 0, 0, 0, 0
                if valid is not None:
                    for k, r in enumerate(rows):
                        if r < n and valid[r]:
                            ok |= 1 << k
                for w in range(W):
                    buf = words[w, lo:hi]
                    at = s - lo
                    ff_mask = _prefix_mask(w, ff_bits)
                    fl_mask = _prefix_mask(w, flank_bits)
                    for k, r in enumerate(rows):
                        j = r - s
                        if r >= hi:
                            continue
                        cur = int(buf[at + j])
                        if r > 0:
                            d = cur ^ int(buf[at + j - 1])
                            any_ |= int(d != 0) << k
                            ff |= int((d & ff_mask) != 0) << k
                            fl |= int((d & fl_mask) != 0) << k
                        if (valid is None and w == field[0]
                                and ((cur >> field[1]) & field[2])
                                != field[2]):
                            ok |= 1 << k
                for k, r in enumerate(rows):
                    edge = r == 0 or r >= n
                    v = r < n and (ok >> k) & 1
                    hf = edge or (any_ >> k) & 1
                    bits = {"head": edge or (fl >> k) & 1,
                            "x": v and (edge or (ff >> k) & 1),
                            "full": hf, "kept": v and hf}
                    for name, bit in bits.items():   # the ballots
                        if bit:
                            maps[name][warp * ww + k] |= 1 << lane
        return maps

    # scan_kernel, step 2: the word scans, one warp of scan_lanes lanes
    def _scans(self, m):
        B, mw, sl = self.B, self.mw, self.scan_lanes
        lw = -(-mw // sl)
        per = []
        for lane in range(sl):
            hc = xc = 0
            last, first_h, first_f = -1, self.span, self.span
            for i in range(lw):
                q = lw * lane + i
                if q >= mw:
                    break
                h, f = m["head"][q], m["full"][q]
                hc += _popc(h)
                xc += _popc(m["x"][q])
                if h:
                    last = B * q + _msb(h)
                    if first_h == self.span:
                        first_h = B * q + _ffs0(h)
                if f and first_f == self.span:
                    first_f = B * q + _ffs0(f)
            per.append((hc, xc, last, first_h, first_f))
        h_in = np.cumsum([p[0] for p in per]).tolist()
        x_in = np.cumsum([p[1] for p in per]).tolist()
        last_in = np.maximum.accumulate([p[2] for p in per]).tolist()
        nh_in = np.minimum.accumulate([p[3] for p in per][::-1])[::-1].tolist()
        nf_in = np.minimum.accumulate([p[4] for p in per][::-1])[::-1].tolist()
        for k in ("head_pre", "x_pre", "last_head", "next_head", "next_full"):
            m[k] = [None] * (mw + 1)
        for lane in range(sl):
            h_run = h_in[lane] - per[lane][0]
            x_run = x_in[lane] - per[lane][1]
            last_run = last_in[lane - 1] if lane else -1
            nh_run = nh_in[lane + 1] if lane + 1 < sl else self.span
            nf_run = nf_in[lane + 1] if lane + 1 < sl else self.span
            for i in range(lw):
                q = lw * lane + i
                if q >= mw:
                    break
                h = m["head"][q]
                m["head_pre"][q], m["x_pre"][q] = h_run, x_run
                m["last_head"][q] = last_run
                h_run += _popc(h)
                x_run += _popc(m["x"][q])
                if h:
                    last_run = B * q + _msb(h)
            for i in reversed(range(lw)):
                q = lw * lane + i
                if q >= mw:
                    continue
                m["next_head"][q], m["next_full"][q] = nh_run, nf_run
                if m["head"][q]:
                    nh_run = B * q + _ffs0(m["head"][q])
                if m["full"][q]:
                    nf_run = B * q + _ffs0(m["full"][q])
        m["head_pre"][mw], m["x_pre"][mw] = h_in[-1], x_in[-1]
        m["x_next"] = [self._x_below(m, nh) if nh < self.span else 0
                       for nh in m["next_head"][:mw]]
        m["x_last"] = [self._x_below(m, lh) if lh >= 0 else 0
                       for lh in m["last_head"][:mw]]

    def _x_below(self, m, p):
        assert p < self.span
        q, b = divmod(p, self.B)
        return m["x_pre"][q] + _popc(m["x"][q] & ((1 << b) - 1))

    def _lookback_fwd(self, fwd, b):
        acc, t0 = (0, 0), b - 1
        while t0 >= 0:
            ws = []
            for lane in range(self.lanes):
                t = t0 - lane
                ws.append(fwd[t] if t >= 0 else _INCL)
                assert ws[-1] != 0, "an earlier tile has not published"
            stops = [lane for lane, w in enumerate(ws) if w >> 62 == 2]
            last = stops[0] if stops else self.lanes - 1
            xs = [_fwd_unpack(w) if lane <= last else (0, 0)
                  for lane, w in enumerate(ws)]
            acc = _fwd_combine(_tree(xs, lambda a, y: _fwd_combine(y, a)),
                               acc)
            self.stats["fwd_windows"] += 1
            if stops:
                break
            t0 -= self.lanes
        return acc

    def _lookback_rev(self, rev, b, nb, n):
        acc, t0 = (False, 0, n), b + 1
        while t0 < nb:
            ws = [rev[t0 + lane] if t0 + lane < nb else _DONE | (n + 1)
                  for lane in range(self.lanes)]
            stops = [lane for lane, w in enumerate(ws)
                     if w & (_DONE | _HAS_HEAD)]
            last = stops[0] if stops else self.lanes - 1
            xs = [_rev_unpack(w) if lane <= last else (False, 0, n)
                  for lane, w in enumerate(ws)]
            acc = _rev_combine(acc, _tree(xs, _rev_combine))
            self.stats["rev_windows"] += 1
            if stops:
                break
            t0 += self.lanes
        return acc

    def run(self, words, valid, field, flank_bits, ff_bits, n_files):
        """(keep, counts, gid) as the two kernels leave them; ``valid`` None
        is layout mode with ``field`` = (word, shift, sentinel)."""
        W, n = words.shape
        T, B, span, tw = self.T, self.B, self.span, self.tw
        nb = -(-n // T)
        fwd, rev, open_ = [0] * nb, [0] * nb, [None] * nb
        keep = np.full(n, 7, np.int64)       # 7, -7: never written
        counts = np.full(n, -7, np.int64)
        gid = np.full(n, -7, np.int64)
        self.stats = dict(open=set(), patched=0, fwd_windows=0,
                          rev_windows=0)
        for w0 in range(0, nb, self.wave):          # scan_kernel
            tiles = range(w0, min(w0 + self.wave, nb))
            maps, own = {}, {}
            for b in tiles:
                s = b * T
                m = maps[b] = self._maps(s, words, valid, field, flank_bits,
                                         ff_bits)
                self._scans(m)
                heads, xs = m["head_pre"][tw], m["x_pre"][tw]
                last_h = m["last_head"][tw]
                own[b] = (heads, xs - self._x_below(m, last_h)
                          if last_h >= 0 else xs)
                fwd[b] = _fwd_pack(_OWN if b else _INCL, own[b])
                fh = (_ffs0(m["head"][0]) if m["head"][0]
                      else m["next_head"][0])
                m["first_x"] = self._x_below(m, fh) if fh < span else -1
                ffh = (_ffs0(m["full"][0]) if m["full"][0]
                       else m["next_full"][0])
                rev[b] = _rev_pack(heads > 0, (
                    heads > 0, m["first_x"] if fh < T else xs,
                    s + ffh if ffh < T else n))
            for b in reversed(tiles):
                s, m = b * T, maps[b]
                before = self._lookback_fwd(fwd, b) if b else (0, 0)
                incl = _fwd_combine(before, own[b])
                if b:
                    fwd[b] = _fwd_pack(_INCL, incl)
                is_open = m["next_head"][tw - 1] == span
                run = -1
                if is_open and m["next_full"][tw - 1] == span:
                    for q in reversed(range(tw)):
                        if m["full"][q]:
                            p = B * q + _msb(m["full"][q])
                            if (m["kept"][q] >> (p % B)) & 1:
                                run = s + p
                            break
                open_[b] = (is_open, incl[1],
                            m["last_head"][tw] if own[b][0] else 0, run)
                if is_open:
                    self.stats["open"].add(b)
                first_keep = (m["first_x"] >= 0
                              and m["first_x"] + before[1] == n_files)
                for r in range(min(T, n - s)):           # step 3
                    q, bit = divmod(r, B)
                    h, f, x = m["head"][q], m["full"][q], m["x"][q]
                    xp = m["x_pre"][q]
                    le = ((1 << B) - 1) >> (B - 1 - bit)
                    gid[s + r] = (before[0] + m["head_pre"][q]
                                  + _popc(h & le) - 1)
                    counts[s + r] = keep[s + r] = 0
                    if not (m["kept"][q] >> bit) & 1:
                        continue
                    fn, hn, hw = f & ~le, h & ~le, h & le
                    counts[s + r] = (B * q + _ffs0(fn) if fn
                                     else m["next_full"][q]) - r
                    x_end = -1
                    if hn:
                        x_end = xp + _popc(x & ((1 << _ffs0(hn)) - 1))
                    elif m["next_head"][q] < span:
                        x_end = m["x_next"][q]
                    if x_end < 0:
                        continue
                    if hw:
                        keep[s + r] = x_end - xp - _popc(
                            x & ((1 << _msb(hw)) - 1)) == n_files
                    elif m["last_head"][q] >= 0:
                        keep[s + r] = x_end - m["x_last"][q] == n_files
                    else:
                        keep[s + r] = first_keep
        for w0 in range(0, nb, self.wave):          # patch_kernel
            tiles = [nb - 1 - x for x in range(w0, min(w0 + self.wave, nb))]
            after = {}
            for b in tiles:
                if not (rev[b] & _DONE and not open_[b][0]):
                    after[b] = (rev[b], self._lookback_rev(rev, b, nb, n))
            for b, (own_w, aft) in after.items():
                if not own_w & _DONE:
                    rev[b] = _rev_pack(True, _rev_combine(_rev_unpack(own_w),
                                                          aft))
                is_open, head_sum, start, run = open_[b]
                if not is_open:
                    continue
                if run >= 0:
                    counts[run] = aft[2] - run
                if head_sum + aft[1] != n_files:
                    continue
                s = b * T
                for r in range(s + start, min(n, s + T)):
                    keep[r] = counts[r] != 0
                    self.stats["patched"] += 1
        assert set(np.unique(keep)) <= {0, 1}, "a keep byte never written"
        assert (counts != -7).all() and (gid != -7).all()
        return keep.astype(bool), counts, gid


SMALL = dict(tile=64, ahead=16, word=8, warps=2, scan_lanes=3, lanes=4,
             wave=3)
KERNEL = dict(tile=_const("kTile"), ahead=_const("kAhead"), word=32,
              warps=_const("kRowWarps"), scan_lanes=32, lanes=32,
              wave=7)


def _emulate(name, params, mode):
    layout, words, valid, n_files = edge_table(name, params["tile"],
                                               params["ahead"], KeyLayout)
    fw, fsh = layout.file_word_shift()
    emu = _Emulation(**params)
    got = emu.run(words, valid if mode == "valid" else None,
                  (fw, fsh, layout.file_sentinel), layout.flank_bits,
                  layout.file_off + layout.file_bits, n_files)
    return layout, words, valid, n_files, got, emu.stats


def _want(layout, words, valid, n_files):
    keep, counts, gid = _port(layout, words, valid, n_files)
    return keep, counts.astype(np.int64), gid.astype(np.int64)


_SMALL_NAMES = [c[0] for c in edge_tables(SMALL["tile"], SMALL["ahead"])]


@pytest.mark.parametrize("name", _SMALL_NAMES)
def test_emulated_kernel_matches_pallas_and_xla(name):
    """The emulated kernel at a 64-row tile and 16-row look-ahead, in
    layout mode, vs survivor_mark_bits, the Pallas kernel (interpret mode)
    and the port's plain version, bit for bit; the valid-array mode too."""
    layout, words, valid, n_files, (keep, counts, gid), stats = _emulate(
        name, SMALL, "layout")
    want = _want(layout, words, valid, n_files)
    for g, r in zip((keep, counts, gid), want):
        np.testing.assert_array_equal(g, r)
    k_x, c_x, g_x = JI.survivor_mark_bits([jnp.asarray(w) for w in words],
                                          layout, n_files)
    np.testing.assert_array_equal(keep, np.asarray(k_x))
    np.testing.assert_array_equal(counts, np.asarray(c_x).astype(np.int64))
    np.testing.assert_array_equal(gid, np.asarray(g_x))
    n = words.shape[1]
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
    got_v = _emulate(name, SMALL, "valid")[4]
    for g, r in zip(got_v, want):
        np.testing.assert_array_equal(g, r)
    # the paths each table is there for were taken
    if name in ("one_group_every_tile", "one_run_every_tile", "long_groups"):
        assert len(stats["open"]) > 1 and stats["rev_windows"] > 1
        assert stats["patched"] > 0 and keep.any()
    if name.startswith("group_of_ahead"):
        # tile 0's last group starts on its last row
        assert (0 in stats["open"]) == (name != "group_of_ahead")
    if name in ("every_row_its_group", "groups_end_on_tile_edges", "one_row"):
        assert not stats["open"]
    if name == "all_rows_invalid":
        assert not keep.any() and not counts.any()


@pytest.mark.parametrize("name", ["several_tiles", "group_of_ahead_plus_1",
                                  "one_group_every_tile", "long_groups"])
def test_emulated_kernel_at_its_own_sizes(name):
    """The emulation at the kernel's tile, look-ahead, warps and 32-bit
    words (read from the source), on edge tables scaled to them."""
    layout, words, valid, n_files, got, stats = _emulate(name, KERNEL,
                                                         "layout")
    for g, r in zip(got, _want(layout, words, valid, n_files)):
        np.testing.assert_array_equal(g, r)
    if name != "several_tiles":
        assert stats["open"]


@pytest.mark.parametrize("seed", range(6))
def test_emulated_kernel_random_tables(seed):
    """Random mixes of short and long groups, both modes, at random small
    tiles, look-aheads, bitmap words and look-back windows."""
    rng = np.random.default_rng(100 + seed)
    word = int(rng.choice([8, 16]))
    params = dict(tile=word * int(rng.integers(2, 6)),
                  ahead=word * int(rng.integers(1, 3)), word=word, warps=1,
                  scan_lanes=int(rng.integers(1, 5)),
                  lanes=int(rng.integers(1, 6)), wave=int(rng.integers(1, 5)))
    W, n_files = int(rng.choice([1, 2, 4, 7])), int(rng.integers(1, 6))
    layout = layout_for(W, n_files, KeyLayout)
    sizes = np.where(rng.random(60) < 0.8, rng.integers(1, 6, 60),
                     rng.integers(1, 6 * params["tile"], 60))
    words = grouped_table(layout, sizes, rng, n_files,
                          mids=int(rng.integers(1, 5)))
    fw, fsh = layout.file_word_shift()
    valid = ((words[fw] >> np.uint32(fsh)) & np.uint32(layout.file_sentinel)
             ) != layout.file_sentinel
    want = _want(layout, words, valid, n_files)
    k_x, c_x, g_x = JI.survivor_mark_bits([jnp.asarray(w) for w in words],
                                          layout, n_files)
    np.testing.assert_array_equal(want[0], np.asarray(k_x))
    np.testing.assert_array_equal(want[1], np.asarray(c_x).astype(np.int64))
    np.testing.assert_array_equal(want[2], np.asarray(g_x))
    for mode in ("layout", "valid"):
        got = _Emulation(**params).run(
            words, valid if mode == "valid" else None,
            (fw, fsh, layout.file_sentinel), layout.flank_bits,
            layout.file_off + layout.file_bits, n_files)
        for g, r in zip(got, want):
            np.testing.assert_array_equal(g, r)
