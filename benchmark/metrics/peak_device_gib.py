"""peak_device_gib: the fullest card's ``torch.cuda.max_memory_allocated``
over the window (every card's reset at its start), in GiB; on one card
that card's."""


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None
