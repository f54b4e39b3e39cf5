"""survivor_scan.roofline_pct: the survivor scan (csrc/survivor_scan.cu,
scan and patch) against its bytes once at the card's peak: the sorted rows
read once at the key's words, and each survivor row (stage ``pull``'s
items) written once with its count and group id."""

from benchmark import problem
from benchmark.stages import stage_sum

KERNELS = ("scan_kernel", "patch_kernel")


def read(run):
    rows = stage_sum(run, ["sort"], "items")
    if run.trace is None or not rows:
        return None
    kept = stage_sum(run, ["pull"], "items") or 0
    w = 4 * run.problem["key_words"]
    return problem.roofline_pct(rows * w + kept * (w + 8),
                                run.trace.kernel_seconds(KERNELS))
