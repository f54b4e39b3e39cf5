"""Host-side result model: flank groups ("alignments") and their members.

Parity model (reference classes, re-designed around the device pipeline's
columnar output instead of line streams):
  - ``Amplicon`` (reference src/krisp/krisp_fasta/Amplicon.py:154-348):
    one unique k-mer split into (left, mid, right) with a multiset of source
    genome labels -> here a lightweight dataclass built from decoded key rows.
  - ``ConservedEndAmplicons`` (Amplicon.py:351-693): all amplicons sharing a
    flank pair, plus diagnostic-column logic and renderers -> ``FlankGroup``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..dna import collapse_to_iupac


def labels_to_string(label_counts: dict[str, int]) -> str:
    """'name' or 'name(count)' entries joined with ';' in sorted order
    (parity: Amplicon.py:170-187)."""
    parts = []
    for name, count in sorted(label_counts.items()):
        parts.append(name if count == 1 else f"{name}({count})")
    return ";".join(parts)


def string_to_labels(text: str) -> list[str]:
    """Inverse of labels_to_string, duplicates expanded
    (parity: Amplicon.py:189-206)."""
    labels = []
    for token in text.split(";"):
        token = token.strip()
        if "(" in token:
            name, mult = token.split("(")
            labels += [name] * int(mult.rstrip(")"))
        else:
            labels.append(token)
    return labels


@dataclass
class KmerAmplicon:
    left: str
    mid: str
    right: str
    label_counts: dict[str, int] = field(default_factory=dict)

    @property
    def sequence(self) -> str:
        return f"{self.left}{self.mid}{self.right}"

    @property
    def labels(self) -> list[str]:
        out = []
        for name in sorted(self.label_counts):
            out += [name] * self.label_counts[name]
        return out

    def __str__(self) -> str:
        return f"{self.sequence} : {labels_to_string(self.label_counts)}"


@dataclass
class FlankGroup:
    left: str
    right: str
    amplicons: list[KmerAmplicon] = field(default_factory=list)
    ingroup: frozenset | None = None
    p3: dict | None = None

    def add(self, amp: KmerAmplicon):
        for existing in self.amplicons:
            if existing.mid == amp.mid:
                for k, v in amp.label_counts.items():
                    existing.label_counts[k] = existing.label_counts.get(k, 0) + v
                return
        self.amplicons.append(amp)

    # -- column analyses (parity: Amplicon.py:483-521) ----------------------

    def diagnostic_columns(self) -> list[int]:
        """Mid positions where more than one distinct base occurs."""
        mids = [a.mid for a in self.amplicons]
        return [i for i, bases in enumerate(zip(*mids)) if len(set(bases)) > 1]

    def ingroup_unique_columns(self) -> list[int]:
        """Mid positions where the ingroup's base set is disjoint from the
        outgroup's.  An amplicon contributes to the ingroup set when any of
        its labels is an ingroup genome (and likewise for outgroup)."""
        if self.ingroup is None:
            return []
        in_mids, out_mids = [], []
        for amp in self.amplicons:
            for label in amp.labels:
                if label in self.ingroup:
                    in_mids.append(amp.mid)
                else:
                    out_mids.append(amp.mid)
        out = []
        for i in range(len(self.amplicons[0].mid) if self.amplicons else 0):
            in_bases = {m[i] for m in in_mids}
            out_bases = {m[i] for m in out_mids}
            if in_bases.isdisjoint(out_bases):
                out.append(i)
        return out

    # -- consensus (parity: Amplicon.py:547-558, 663-671) -------------------

    def consensus(self, labels=None) -> dict[str, str]:
        if labels is None:
            amps = self.amplicons
        else:
            amps = [a for a in self.amplicons if set(a.labels).issubset(labels)]
        return {
            "forward": collapse_to_iupac([a.left for a in amps]),
            "diagnostic": collapse_to_iupac([a.mid for a in amps]),
            "reverse": collapse_to_iupac([a.right for a in amps]),
        }

    def ingroup_consensus(self) -> dict[str, str]:
        return self.consensus(self.ingroup)
