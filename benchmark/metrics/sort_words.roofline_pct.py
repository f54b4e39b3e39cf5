"""sort_words.roofline_pct: the sort kernel (csrc/sort_words.cu, every
kernel of it) against its bytes once at the card's peak: the rows the
program hands it (stage ``sort``'s items: the whole table, or the rows the
prefilter kept) read and written once at the key's words."""

from benchmark import problem
from benchmark.stages import stage_sum

KERNELS = ("vary_kernel", "histogram_kernel", "offsets_kernel",
           "onesweep_kernel", "gather_word_kernel", "gather_rows_kernel")


def read(run):
    rows = stage_sum(run, ["sort"], "items")
    if run.trace is None or not rows:
        return None
    seconds = run.trace.kernel_seconds(KERNELS)
    return problem.roofline_pct(2 * rows * 4 * run.problem["key_words"],
                                seconds)
