"""pack_upload_s: seconds a search in stage ``upload``: each genome's
padded bytes copied to the card as they are, on the 2-bit and the 4-bit
route alike; the stage synchronises the card.  Stage ``pack+upload``, the
host 2-bit pack that the program ran before it uploaded the bytes, is read
too, so an older tree reads on the same scale."""

from benchmark.stages import per_search


def read(run):
    return per_search(run, ["pack+upload", "upload"])
