"""kmers_per_s: the windows the window's searches weighed (both strands of
every genome, ``problem.kmers``) over the window's wall seconds."""


def read(run):
    if run.window_s <= 0 or not run.work:
        return None
    return run.work / run.window_s
