"""pack_upload_s: seconds a search in the host 2-bit pack and upload
(stage ``pack+upload``) or the upload of the bytes on the 4-bit route
(stage ``upload``); both stages synchronise the card."""

from benchmark.stages import per_search


def read(run):
    return per_search(run, ["pack+upload", "upload"])
