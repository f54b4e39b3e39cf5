"""Sorted KeyLayout tables for the survivor-scan tests: flank groups of
chosen sizes, so that groups and runs end where a test wants them (on a
tile's edge, at the end of the kernel's look-ahead, nowhere short of the
table's end).  Plain numpy, no JAX: the card's tests use it too."""

import numpy as np

#: key words -> geometry (left, mid, right[, bits]) with that many words
GEOMS = {1: (5, 1, 3), 2: (25, 1, 2), 4: (25, 1, 2, 4), 7: (30, 40, 30)}


def layout_for(W, n_files, layout_cls):
    geom = GEOMS[W]
    layout = layout_cls(*geom[:3], geom[3] if len(geom) > 3 else 2, n_files)
    assert layout.n_words == W
    return layout


def grouped_table(layout, sizes, rng, n_files, ids=None, mids=4, tile=None):
    """uint32[W, n] sorted: flank groups of the given sizes (flank value =
    group number); each row's genome id random in [0, n_files] with
    n_files standing for the sentinel (``ids`` None), the sentinel on
    every row (``ids`` "sentinel") or the row's tile, row // ``tile``, so
    that runs end on tile edges (``ids`` "tiles"); each row's mid one of
    ``mids`` values.  Runs of every length follow."""
    n = int(sum(sizes))
    top = 32 * layout.n_words
    group = np.repeat(np.arange(len(sizes)), sizes)
    if ids is None:
        f = rng.integers(0, n_files + 1, n)
        f = np.where(f == n_files, layout.file_sentinel, f)
    elif ids == "sentinel":
        f = np.full(n, layout.file_sentinel)
    else:
        f = np.arange(n) // tile
        assert f.max() < layout.file_sentinel
    mid = (rng.integers(0, mids, n) if layout.total_bits > layout.mid_off
           else np.zeros(n, int))
    keys = sorted((int(g) << (top - layout.flank_bits))
                  | (int(i) << (top - layout.file_off - layout.file_bits))
                  | (int(m) << (top - layout.total_bits))
                  for g, i, m in zip(group, f, mid))
    return np.array([[(k >> (32 * (layout.n_words - 1 - w))) & 0xFFFFFFFF
                      for k in keys] for w in range(layout.n_words)],
                    np.uint32).reshape(layout.n_words, n)


def edge_tables(T, A):
    """(name, W, n_files, group sizes, mids, ids) at tile T, look-ahead A."""
    return [
        ("one_row", 2, 3, [1], 4, None),
        ("tile_minus_1", 2, 3, [T - 1], 4, None),
        ("tile", 1, 2, [5] * (T // 5) + [T % 5], 4, None),
        ("tile_plus_1", 4, 3, [T + 1], 4, None),
        ("several_tiles", 2, 5, [3, 1, 7, 2] * T, 2, None),
        ("groups_end_on_tile_edges", 2, 3, [T] * 5, 4, None),
        ("halves_end_on_tile_edges", 7, 3, [T // 2] * 9, 4, None),
        # one group of 4 tiles, each tile one run of its own genome id
        ("runs_end_on_tile_edges", 2, 4, [4 * T], 1, "tiles"),
        # a group starting on a tile's last row: closed by the look-ahead
        # at length A, open at A + 1
        ("group_of_ahead", 2, 3, [T - 1, A, 2 * T], 4, None),
        ("group_of_ahead_plus_1", 2, 3, [T - 1, A + 1, 2 * T], 4, None),
        ("group_of_ahead_plus_2", 4, 3, [T - 1, A + 2, T], 4, None),
        ("one_group_every_tile", 2, 3, [7 * T + 3], 4, None),
        ("one_run_every_tile", 1, 2, [5 * T + 1], 1, None),
        ("every_row_its_group", 2, 3, [1] * (3 * T + 5), 4, None),
        ("all_rows_invalid", 2, 3, [T // 3, 2 * T, 9], 4, "sentinel"),
        ("long_groups", 7, 5, [3 * T + 1, 2, 5 * T - 3, A, T], 4, None),
    ]


def edge_table(name, T, A, layout_cls):
    """(layout, words uint32[W, n], valid bool[n], n_files) of the edge
    table ``name`` at tile T and look-ahead A."""
    for case in edge_tables(T, A):
        if case[0] == name:
            break
    else:
        raise KeyError(name)
    _, W, n_files, sizes, mids, ids = case
    layout = layout_for(W, n_files, layout_cls)
    rng = np.random.default_rng(len(name) + sum(sizes))
    words = grouped_table(layout, sizes, rng, n_files, ids, mids, T)
    fw, fsh = layout.file_word_shift()
    valid = ((words[fw] >> np.uint32(fsh)) & np.uint32(layout.file_sentinel)
             ) != layout.file_sentinel
    return layout, words, valid, n_files
