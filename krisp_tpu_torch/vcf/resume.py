"""Checkpoint/resume for long krisp_vcf scans.

The reference has no resume story for its whole-genome scans
(reference src/krisp/krisp_vcf/krisp_vcf.py:1320-1388 restarts from
scratch); multi-hour cohort scans lose everything on a crash.  Here a
sidecar file next to the output CSV records, after every completed chunk,
the chunk index, the exact byte offsets of the CSV/alignment outputs, and
the writer's running status counters.  On ``--resume`` the outputs are
truncated back to the last completed chunk boundary (discarding any rows a
crashed chunk half-wrote) and the scan continues from the next chunk — the
final files are byte-identical to an uninterrupted run.

The sidecar carries a fingerprint of the inputs and every output-affecting
argument; a resume against different inputs/arguments is refused.
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path


def _fingerprint(args, chunks) -> str:
    """Hash of everything that determines the output stream."""
    h = hashlib.sha256()
    keys = ("metadata", "reference", "vcf", "sample_col", "group_col",
            "groups", "chroms", "pos", "min_samples", "min_samp_prop",
            "min_reads", "min_geno_qual", "min_var_qual", "min_freq",
            "min_map_qual", "min_bases", "var_location", "crrna_len",
            "tm", "gc", "amp_size", "primer_size", "max_sec_tm",
            "gc_clamp", "max_end_gc", "force", "out_align")
    payload = {k: getattr(args, k, None) for k in keys}
    for p_key in ("metadata", "reference", "vcf"):
        p = getattr(args, p_key, None)
        if p and p != "-" and os.path.exists(p):
            st = os.stat(p)
            payload[p_key + "__stat"] = [st.st_size, int(st.st_mtime)]
    payload["chunks"] = chunks
    h.update(json.dumps(payload, sort_keys=True, default=str).encode())
    return h.hexdigest()


class ScanProgress:
    """Sidecar-backed progress log for the serial/in-process chunk loop."""

    def __init__(self, out_csv: str, args, chunks):
        self.path = Path(str(out_csv) + ".progress")
        self.fingerprint = _fingerprint(args, chunks)
        self.n_chunks = len(chunks)
        self.next_chunk = 0
        self.csv_offset = 0
        self.align_offset = 0
        self.counters = None

    def load(self) -> bool:
        """Read the sidecar; True when this run can resume from it."""
        if not self.path.exists():
            return False
        try:
            state = json.loads(self.path.read_text())
        except (OSError, ValueError):
            return False
        if state.get("fingerprint") != self.fingerprint:
            raise SystemExit(
                f"--resume: {self.path} was written by a run with different "
                "inputs or arguments; delete it (or the output CSV) to "
                "start over")
        self.next_chunk = int(state["next_chunk"])
        self.csv_offset = int(state["csv_offset"])
        self.align_offset = int(state["align_offset"])
        self.counters = state.get("counters")
        return self.next_chunk > 0

    def truncate_outputs(self, out_csv: str, out_align: str | None):
        """Drop any bytes written past the last completed chunk."""
        if os.path.exists(out_csv):
            with open(out_csv, "r+b") as fh:
                fh.truncate(self.csv_offset)
        if out_align and os.path.exists(out_align):
            with open(out_align, "r+b") as fh:
                fh.truncate(self.align_offset)

    @staticmethod
    def _byte_offset(stream) -> int:
        """Current byte position of a (text or binary) file stream."""
        stream.flush()
        buf = getattr(stream, "buffer", None)
        return buf.tell() if buf is not None else stream.tell()

    def mark_done(self, chunk_idx: int, writer):
        """Record chunk ``chunk_idx`` complete; offsets taken from the
        (flushed) writer streams."""
        csv_off = self._byte_offset(writer.output_stream)
        align_off = 0
        if writer.out_align is not None:
            align_off = self._byte_offset(writer.out_align)
        state = {
            "fingerprint": self.fingerprint,
            "next_chunk": chunk_idx + 1,
            "n_chunks": self.n_chunks,
            "csv_offset": csv_off,
            "align_offset": align_off,
            "counters": {
                "variant_counts": writer.variant_counts,
                "group_counts": writer.group_counts,
                "header_printed": writer.result_header_printed,
            },
        }
        tmp = self.path.with_suffix(".progress.tmp")
        tmp.write_text(json.dumps(state))
        os.replace(tmp, self.path)

    def restore_writer(self, writer):
        """Re-seed the status counters so the resumed run's status line and
        total match an uninterrupted scan."""
        if not self.counters:
            return
        writer.variant_counts.update(self.counters["variant_counts"])
        writer.group_counts.update(self.counters["group_counts"])
        writer.result_header_printed = self.counters["header_printed"]

    def finish(self):
        """Scan completed: the sidecar has served its purpose."""
        try:
            self.path.unlink()
        except OSError:
            pass
