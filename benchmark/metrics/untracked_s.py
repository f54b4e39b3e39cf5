"""untracked_s: seconds a search outside every stage of the program: its
wall time less the sum of its stages (the CLI's glue, ``detect_bits``,
``_stack``, the survivors' ``dna.decode_bits``, the diagnostic filter and
the render)."""


def read(run):
    if not run.searches:
        return None
    rest = [s["wall_s"] - sum(v["seconds"] for v in s["stages"].values())
            for s in run.searches]
    return sum(rest) / len(rest)
