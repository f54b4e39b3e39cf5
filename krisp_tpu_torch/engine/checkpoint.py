"""Checkpoint / resume for the k-mer engine.

The reference has no checkpointing — its only resume affordance is that
per-file sorted k-mer temp files persist inside the workdir during a run
(krisp_fasta.py:224, SURVEY.md §5).  Here per-genome unique tables are
first-class checkpoints: content-addressed by (file bytes, geometry,
encoding, softmask policy), so an interrupted or repeated run skips
extraction+sort for unchanged genomes and goes straight to the global
intersection.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np


def _table_key(path: str, geom, bits: int, omit_soft: bool,
               n_files: int) -> str:
    # v3: tables store bit-packed KeyLayout rows (width depends on the
    # genome-id field / n_files) plus the sorted sub-run offsets that the
    # range-partitioned global stage slices by (engine/bigscale.py)
    h = hashlib.sha256()
    h.update(f"{geom.left},{geom.mid},{geom.right},{bits},{omit_soft},"
             f"{n_files},v3".encode())
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()[:32]


class TableCache:
    """On-disk cache of per-genome sorted unique k-mer tables."""

    def __init__(self, directory: str):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)

    def _path(self, key: str) -> Path:
        return self.dir / f"kmer_table_{key}.npz"

    def load(self, path: str, geom, bits: int, omit_soft: bool,
             n_files: int = 1):
        """Return (words [W, n] uint32, counts uint32, offsets int64) or
        None.  ``offsets`` delimit the sorted sub-runs of the table (one
        per extraction chunk): rows [offsets[i], offsets[i+1]) are sorted
        by full key."""
        f = self._path(_table_key(path, geom, bits, omit_soft, n_files))
        if not f.exists():
            return None
        try:
            data = np.load(f)
            return data["words"], data["counts"], data["offsets"]
        except Exception:
            return None

    def store(self, path: str, geom, bits: int, omit_soft: bool,
              words: np.ndarray, counts: np.ndarray, offsets: np.ndarray,
              n_files: int = 1):
        f = self._path(_table_key(path, geom, bits, omit_soft, n_files))
        tmp = f.with_suffix(".tmp.npz")
        # compress small tables only: GB-scale key tables are near-random
        # bits (compression is slow and saves nothing)
        save = (np.savez_compressed if words.nbytes < (64 << 20)
                else np.savez)
        save(tmp, words=words, counts=counts,
             offsets=np.asarray(offsets, np.int64))
        tmp.replace(f)

    def manifest(self):
        return sorted(p.name for p in self.dir.glob("kmer_table_*.npz"))
