"""The one genome generator: a traffic mix (``traffic/<name>.json``) is a
set of its parameters, a configuration (``configs/<name>.json``) gives the
genome count, size and window geometry, and the seed gives the bases.
A mix sets what sets it apart (``substitution_rate``, ``iupac_every``);
every other parameter takes its value from ``SHAPE`` unless the mix
names it.

Per genome, in this order:

1. background: independent uniform A/C/G/T (``substitution_rate`` null),
   or a copy of one uniform ancestor with that share of its bases
   substituted, drawn independently per genome (related species);
2. ``iupac_every``: one of R/Y/S/W/K/M every that many bases (0: none);
3. ``softmask``: lower-case runs (repeat masking);
4. ``n_gaps``: runs of N (assembly gaps);
5. ``planted``: regions of one window each, at evenly spaced slots over
   which the kinds are spread, so every kind lies in both halves of a
   genome (see ``KINDS``); every ``reverse_every``-th slot holds its
   region as the reverse complement, so the reverse strand finds it;

then the genome is cut into ``contigs`` records of equal length and
written as FASTA with lines of ``line_width`` bases.  Every seed gives the
same sizes, counts and slots; only the bases, the runs' places and the
outgroup chosen for the one-genome kinds differ.  All vectorised NumPy.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

ACGT = np.frombuffer(b"ACGT", np.uint8)
IUPAC_CYCLE = np.frombuffer(b"RYSWKM", np.uint8)

#: planted kinds, each one window long (flank, middle, flank):
#:   shared       one random window, equal in every genome: survives, and
#:                the filter drops it (no column tells the groups apart)
#:   diagnostic   shared flanks, one middle in the ingroup, a middle that
#:                differs at every base in each outgroup genome: passes
#:   partial      as diagnostic, the outgroup middle differing at a random
#:                half of the positions (at least one): passes
#:   missing_one  diagnostic, left out of one genome: does not survive
#:   n_in_one     diagnostic, one base of one genome's window an N: does
#:                not survive
#:   mixed        ingroup middles X and Y, the first outgroup X, the others
#:                a third: survives, the filter drops it
#:   repeated     diagnostic, planted a second time in the first ingroup
#:                genome: passes with that genome counted twice
KINDS = ("shared", "diagnostic", "partial", "missing_one", "n_in_one",
         "mixed", "repeated")

#: The assembly's shape and the planted regions, the same in every mix.
#: Assumed, not read from a published assembly: 16 records of 2.5 Mb, as
#: a chromosome-level assembly (a draft of the same size may hold hundreds
#: or thousands of contigs), 1 % soft-masked in runs of 400 and 0.05 % N
#: in gaps of 100.  Every stage of a search handles a lower-case base as
#: it does an upper-case one, and a record boundary voids L - 1 windows a
#: strand.
SHAPE = {
    "substitution_rate": None,
    "iupac_every": 0,
    "contigs": 16,
    "line_width": 80,
    "reverse_every": 2,
    "softmask": {"per_mb": 25, "length": 400},
    "n_gaps": {"per_mb": 5, "length": 100},
    "planted": {"shared": 3, "diagnostic": 4, "partial": 4, "missing_one": 4,
                "n_in_one": 4, "mixed": 4, "repeated": 4},
}


@dataclass
class GenomeSet:
    paths: list[str]
    ingroup: list[str]
    outgroup: list[str]
    contig_lengths: list[list[int]]
    four_bit: bool                   # any letter beyond A/C/G/T/N
    planted: list = field(default_factory=list)   # (kind, slot, position)


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """A generator for one stream of one seed; any whole number is a seed
    (negative ones and ones past 64 bits are taken modulo 2**64)."""
    return np.random.default_rng([seed % (1 << 64), *stream])


def _differs(rng, x: np.ndarray, mask=None) -> np.ndarray:
    """A copy of base codes ``x`` changed at every position (or at
    ``mask``) to another base."""
    y = (x + rng.integers(1, 4, x.size, dtype=np.uint8)) % 4
    return y if mask is None else np.where(mask, y, x).astype(np.uint8)


def _slot_kinds(planted: dict) -> list[str]:
    """Kinds spread evenly over the slots (the i-th of a kind's c regions
    at (i + 1/2) / c of the genome); ``repeated`` takes a second slot of
    its own after all others."""
    counts = {k: int(planted.get(k, 0)) for k in KINDS}
    unknown = set(planted) - set(KINDS)
    if unknown:
        raise ValueError(f"unknown planted kinds {sorted(unknown)}")
    ranked = sorted(((i + 0.5) / c, KINDS.index(k), k)
                    for k, c in counts.items() for i in range(c))
    return [k for _, _, k in ranked] + ["repeated_copy"] * counts["repeated"]


def _contig_starts(bases: int, contigs: int) -> np.ndarray:
    return (np.arange(contigs + 1, dtype=np.int64) * bases) // contigs


def _slot_positions(bases: int, n_slots: int, L: int,
                    starts: np.ndarray) -> list[int]:
    """Evenly spaced window starts, each moved off a contig boundary."""
    out = []
    for j in range(n_slots):
        p = int((2 * j + 1) * bases // (2 * n_slots))
        c = int(np.searchsorted(starts, p, side="right")) - 1
        if p + L > starts[c + 1]:
            p = int(starts[c + 1]) + L
        if p + L > bases:
            raise ValueError("genome too short for its planted regions")
        out.append(p)
    return out


def _plant_codes(kinds, n_genomes: int, n_in: int, geom, rng):
    """Per slot the window's base codes in each genome (None: no plant),
    and per slot the genome whose window gets an N (or -1)."""
    left, mid, right = geom
    L = left + mid + right
    out, n_at = [], []
    repeats = []
    for kind in kinds:
        n_genome = -1
        if kind == "repeated_copy":
            # the repeated region's window, again, in the first ingroup genome
            win = repeats.pop(0)
            out.append([win[0]] + [None] * (n_genomes - 1))
            n_at.append(-1)
            continue
        if kind == "shared":
            w = rng.integers(0, 4, L, dtype=np.uint8)
            wins = [w] * n_genomes
        else:
            fl = rng.integers(0, 4, left, dtype=np.uint8)
            fr = rng.integers(0, 4, right, dtype=np.uint8)
            x = rng.integers(0, 4, mid, dtype=np.uint8)
            if kind == "mixed":
                y = _differs(rng, x)
                z = np.array([({0, 1, 2, 3} - {a, b}).pop() for a, b
                              in zip(x.tolist(), y.tolist())], np.uint8)
                mids = [x if g == 0 else y if g < n_in else
                        x if g == n_in else z for g in range(n_genomes)]
            elif kind == "partial":
                mask = rng.random(mid) < 0.5
                mask[rng.integers(0, mid)] = True
                y = _differs(rng, x, mask)
                mids = [x if g < n_in else y for g in range(n_genomes)]
            else:
                mids = [x if g < n_in else _differs(rng, x)
                        for g in range(n_genomes)]
            wins = [np.concatenate([fl, m, fr]) for m in mids]
            if kind == "missing_one":
                wins[int(rng.integers(0, n_genomes))] = None
            elif kind == "n_in_one":
                n_genome = int(rng.integers(0, n_genomes))
            elif kind == "repeated":
                repeats.append(wins)
        out.append(wins)
        n_at.append(n_genome)
    return out, n_at


def _background(traffic: dict, bases: int, n_genomes: int, seed: int):
    rate = traffic["substitution_rate"]
    if rate is None:
        for g in range(n_genomes):
            yield rng_for(seed, 1, g).integers(0, 4, bases, dtype=np.uint8)
        return
    ancestor = rng_for(seed, 0).integers(0, 4, bases, dtype=np.uint8)
    for g in range(n_genomes):
        rng = rng_for(seed, 1, g)
        hit = np.flatnonzero(rng.random(bases, dtype=np.float32) < rate)
        seq = ancestor.copy()
        seq[hit] = _differs(rng, ancestor[hit])
        yield seq


def _runs(rng, bases: int, per_mb: float, length: int) -> np.ndarray:
    """Start positions of ``per_mb`` runs a megabase, each ``length``
    long."""
    n = int(round(per_mb * bases / 1e6))
    return rng.integers(0, bases - length, n)


def _write_fasta(path: Path, seq: np.ndarray, starts: np.ndarray, name: str,
                 width: int) -> list[int]:
    lengths = []
    with open(path, "wb") as fh:
        for c in range(starts.size - 1):
            part = seq[starts[c]:starts[c + 1]]
            lengths.append(int(part.size))
            fh.write(f">{name}_contig{c}\n".encode())
            full = part.size // width * width
            rows = part[:full].reshape(-1, width)
            nl = np.full((rows.shape[0], 1), ord("\n"), np.uint8)
            fh.write(np.hstack([rows, nl]).tobytes())
            if full < part.size:
                fh.write(part[full:].tobytes() + b"\n")
    return lengths


def make_genomes(config: dict, traffic: dict, seed: int,
                 out_dir: Path) -> GenomeSet:
    """Write the configuration's genomes under this traffic mix and seed
    as ``out_dir/genome<i>.fasta``; genomes 0 to ``ingroup`` - 1 are the
    ingroup, the rest the outgroup."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    traffic = {**SHAPE, **traffic}
    n_genomes, n_in = int(config["genomes"]), int(config["ingroup"])
    bases = int(config["genome_bases"])
    geom = (int(config["window"]["left"]), int(config["window"]["mid"]),
            int(config["window"]["right"]))
    L = sum(geom)
    contigs = int(traffic["contigs"])
    starts = _contig_starts(bases, contigs)
    kinds = _slot_kinds(traffic["planted"])
    slots = _slot_positions(bases, len(kinds), L, starts)
    plants, n_at = _plant_codes(kinds, n_genomes, n_in, geom,
                                rng_for(seed, 2))
    iupac_every = int(traffic["iupac_every"])
    soft, gaps = traffic["softmask"], traffic["n_gaps"]
    width = int(traffic["line_width"])
    reverse = int(traffic["reverse_every"])
    paths, lengths = [], []
    for g, codes in enumerate(_background(traffic, bases, n_genomes, seed)):
        seq = ACGT[codes]
        del codes
        if iupac_every:
            pos = np.arange(iupac_every // 2, bases, iupac_every)
            seq[pos] = IUPAC_CYCLE[np.arange(pos.size) % IUPAC_CYCLE.size]
        rng = rng_for(seed, 3, g)
        for p in _runs(rng, bases, soft["per_mb"], soft["length"]):
            seq[p:p + soft["length"]] |= 0x20
        for p in _runs(rng, bases, gaps["per_mb"], gaps["length"]):
            seq[p:p + gaps["length"]] = ord("N")
        for slot, (pos, wins) in enumerate(zip(slots, plants)):
            if wins[g] is not None:
                flip = reverse and slot % reverse == reverse - 1
                seq[pos:pos + L] = ACGT[3 - wins[g][::-1] if flip
                                        else wins[g]]
            if n_at[slot] == g:
                seq[pos + int(rng_for(seed, 4, slot).integers(0, L))] = \
                    ord("N")
        path = out_dir / f"genome{g}.fasta"
        lengths.append(_write_fasta(path, seq, starts, f"genome{g}", width))
        paths.append(str(path))
    return GenomeSet(paths=paths, ingroup=paths[:n_in],
                     outgroup=paths[n_in:], contig_lengths=lengths,
                     four_bit=iupac_every > 0,
                     planted=list(zip(kinds, range(len(kinds)), slots)))
