"""The yardstick's arithmetic: the work of one search and the bytes its
kernels have to move, from the problem's shape alone, and the card's
published peak.

A roofline share is ``bytes / PEAK_BYTES_PER_S`` over the device time of
the kernels that do the work; none of these kernels does enough
arithmetic to be bound by operations.  Over several cards that time sums
every launch on every card (``Trace.kernel_seconds``), so the share is
the bytes over one card's peak times card-seconds: the same share of each
card's peak, whatever the card count.  The bytes are those of the problem,
so a later kernel that does the same work is measured against the same
bytes.
"""

from __future__ import annotations

#: NVIDIA H100 SXM, HBM3, the data sheet's 3.35 TB/s (at its 700 W limit)
PEAK_BYTES_PER_S = 3.35e12


def windows(contig_lengths, L: int) -> int:
    """Window starts of one strand of one genome: ``len - L + 1`` a
    record."""
    return sum(max(c - L + 1, 0) for c in contig_lengths)


def kmers(genome_contigs, L: int) -> int:
    """Windows one search weighs: both strands of every genome."""
    return sum(2 * windows(c, L) for c in genome_contigs)


def key_words(L: int, bits: int, n_genomes: int) -> int:
    """32-bit words of the least key that orders a window: ``bits`` a
    letter (2 for A/C/G/T, 4 with IUPAC letters) and a genome id wide
    enough for a sentinel beside every genome, rounded up to a letter."""
    id_bits = max(bits, n_genomes.bit_length())
    id_bits = -(-id_bits // bits) * bits
    return -(-(L * bits + id_bits) // 32)


def roofline_pct(n_bytes: float, seconds: float) -> float | None:
    """Share of the card's peak bandwidth, in %; None without device
    time."""
    if not seconds or seconds <= 0:
        return None
    return 100.0 * n_bytes / PEAK_BYTES_PER_S / seconds
