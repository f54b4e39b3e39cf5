"""The control of a cell's check: the plain reference with one guarantee
of the configuration broken (its ``control``: the reverse strand left
out), put in the program's place and judged by the benchmark's own
comparison.  It has to come out as not correct.

    python benchmark/control.py --workload <cell> --seeds 1 2 3
        [--device cuda]

One JSON line a seed: the numbers the comparison gives the control, each
beside its limit, and whether they pass.  The benchmark's own runs never
run this; PERF.md keeps its readings at each cell's size on the card.
"""

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)

from benchmark import compare, harness  # noqa: E402
from benchmark.reference import fasta_search  # noqa: E402


def control_reading(config: dict, traffic: dict, seed: int,
                    device: str) -> dict:
    """The comparison's numbers for the control against the reference on
    the cell's genomes of ``seed``."""
    from benchmark.genomes import make_genomes
    work = Path(tempfile.mkdtemp(prefix="krisp_bench_control_"))
    try:
        g = make_genomes(config, traffic, seed, work)
        geom = fasta_search.Geometry(config["window"]["left"],
                                     config["window"]["mid"],
                                     config["window"]["right"])
        t0 = time.perf_counter()
        want_csv, want_align, facts = fasta_search.search(
            g.ingroup, g.outgroup, geom, device)
        t1 = time.perf_counter()
        got = fasta_search.search(g.ingroup, g.outgroup, geom, device,
                                  strands=("+",))
        numbers = compare.compare([got[:2]], want_csv, want_align)
        return {"seed": seed, "numbers": numbers,
                "passes": compare.passed(numbers),
                "reference_s": t1 - t0, "facts": facts}
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    _, config, traffic = harness.cell_inputs(harness.load_manifest(),
                                             args.workload)
    for seed in args.seeds:
        r = control_reading(config, traffic, seed, args.device)
        print(json.dumps({"workload": args.workload, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
