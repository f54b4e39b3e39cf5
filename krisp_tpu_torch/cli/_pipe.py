"""Graceful downstream-pipe-closure handling for the CLIs.

``krisp_vcf ... | head`` must exit cleanly when ``head`` closes the pipe,
not die with a BrokenPipeError traceback (the reference CLIs traceback
here; a production tool should not).
"""

from __future__ import annotations

import functools
import os
import sys


def pipe_safe(fn):
    """Wrap a CLI ``main`` so a closed stdout pipe is a clean exit 0."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except BrokenPipeError:
            # If stdout itself is the dead pipe, point it at devnull so the
            # interpreter's exit-time flush cannot raise a second time.
            # (When stdout is healthy — e.g. the error came from elsewhere —
            # leave it alone.)
            try:
                sys.stdout.flush()
            except (BrokenPipeError, OSError, ValueError):
                try:
                    os.dup2(os.open(os.devnull, os.O_WRONLY),
                            sys.stdout.fileno())
                except (OSError, ValueError):
                    pass
            return 0

    return wrapper
