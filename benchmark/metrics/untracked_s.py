"""untracked_s: seconds a search outside every stage of the program: its
wall time less the sum of its stages.  Every host step of a search is a
stage of its own (``detect_bits``, ``stack``, ``decode``, ``filter``,
``render`` among them), so what is left is the CLI's glue: runtime
set-up, arguments, routing and freeing the search's objects."""


def read(run):
    if not run.searches:
        return None
    rest = [s["wall_s"] - sum(v["seconds"] for v in s["stages"].values())
            for s in run.searches]
    return sum(rest) / len(rest)
