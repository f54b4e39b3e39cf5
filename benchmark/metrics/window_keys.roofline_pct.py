"""window_keys.roofline_pct: the window-key kernel (csrc/window_keys.cu)
against its bytes once at the card's peak: every genome's bases read
once, a byte each, and both strands' key rows written once, 4 bytes a key
word, for each search of the window (``problem.py``)."""

from benchmark import problem

KERNELS = ("window_keys_kernel",)


def read(run):
    if run.trace is None:
        return None
    seconds = run.trace.kernel_seconds(KERNELS)
    p = run.problem
    per_search = p["bases"] + p["kmers"] * 4 * p["key_words"]
    return problem.roofline_pct(per_search * len(run.searches), seconds)
