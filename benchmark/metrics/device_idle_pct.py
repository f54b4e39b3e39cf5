"""device_idle_pct: the share of the traced window in which no kernel,
copy or memset ran on a card (``torch.profiler``'s device timeline), each
card's own, averaged over the cell's cards (``Trace.busy_s``)."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
