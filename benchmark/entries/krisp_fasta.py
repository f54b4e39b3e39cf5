"""Entry ``krisp_fasta``: one search is
``krisp_tpu_torch.cli.krisp_fasta.main(argv)`` in this process, as a user
runs ``krisp_fasta <ingroup> --outgroup <outgroup> <geometry> --devices
<chips> -s <csv> -o <alignment>``: no primer design, no work directory, no
``KRISP_TPU_*`` variable, so the cards' own budget routes the search over
the cell's ``chips`` cards.

The work of a search is every window it weighs, both strands of every
genome (``problem.kmers``).  ``check`` works the answer out again with the
plain reference and compares every search's texts with it.
"""

from __future__ import annotations

from pathlib import Path

from .. import compare, problem
from ..genomes import make_genomes
from ..reference import fasta_search


class Entry:
    def __init__(self, config: dict, traffic: dict, seed: int,
                 workdir: Path, device: str = "cuda", chips: int = 1):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.workdir = Path(workdir)
        self.device, self.chips = device, chips
        w = config["window"]
        self.geom = (int(w["left"]), int(w["mid"]), int(w["right"]))
        self.L = sum(self.geom)
        self.genomes = None
        self.outputs = []   # (csv path, alignment path) per search

    def setup(self):
        """Write the genomes (set-up; the window reads them again each
        search, as a user's runs do)."""
        self.genomes = make_genomes(self.config, self.traffic, self.seed,
                                    self.workdir / "genomes")

    def problem(self) -> dict:
        g = self.genomes
        bits = 4 if g.four_bit else 2
        return {"kmers": problem.kmers(g.contig_lengths, self.L),
                "bases": sum(sum(c) for c in g.contig_lengths),
                "key_words": problem.key_words(self.L, bits, len(g.paths))}

    def argv(self, tag: str) -> list[str]:
        out = self.workdir / "out"
        out.mkdir(exist_ok=True)
        csv, align = out / f"{tag}.csv", out / f"{tag}.txt"
        self.outputs.append((csv, align))
        argv = [*self.genomes.ingroup, "--outgroup", *self.genomes.outgroup,
                *self.config["flags"], "--devices", str(self.chips),
                "-s", str(csv), "-o", str(align)]
        if self.device != "cuda":
            argv += ["--device", self.device]
        return argv

    def search(self, tag: str) -> int:
        """One search; returns its work (k-mers)."""
        from krisp_tpu_torch.cli.krisp_fasta import main
        rc = main(self.argv(tag))
        if rc not in (0, None):
            raise RuntimeError(f"krisp_fasta returned {rc}")
        return problem.kmers(self.genomes.contig_lengths, self.L)

    def texts(self):
        def read(p):
            return p.read_text() if p.exists() else None
        return [(read(c), read(a)) for c, a in self.outputs]

    def check(self, device: str) -> tuple[dict, dict]:
        """({number: value}, facts about the reference) over every
        search."""
        want_csv, want_align, facts = fasta_search.search(
            self.genomes.ingroup, self.genomes.outgroup,
            fasta_search.Geometry(*self.geom), device)
        facts["csv_rows"] = want_csv.count("\n") - 1
        return compare.compare(self.texts(), want_csv, want_align), facts
