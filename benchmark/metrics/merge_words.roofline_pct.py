"""merge_words.roofline_pct: the merge kernel (csrc/merge_words.cu,
``split_kernel`` and ``merge_kernel``, every launch on every card) against
the bytes of a one-pass merge at the card's peak: the rows the owners
received (stage ``merge``'s items) read once and written once at the
key's words.  The sharded route merges an owner's runs in a pairwise tree
(``parallel.distributed.merge_runs``): over four runs each row is read
and written at two levels, so the share tops out near half."""

from benchmark import problem
from benchmark.stages import stage_sum

KERNELS = ("split_kernel", "merge_kernel")


def read(run):
    rows = stage_sum(run, ["merge"], "items")
    if run.trace is None or not rows:
        return None
    return problem.roofline_pct(2 * rows * 4 * run.problem["key_words"],
                                run.trace.kernel_seconds(KERNELS))
