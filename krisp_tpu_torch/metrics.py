"""Per-stage wall timers, program spans and profiler traces (the
``krisp_tpu.metrics`` API).

A stage given a CUDA ``device`` synchronises that device at its end, so its
wall time covers the device work it queued and not only the enqueue.
While a ``torch.profiler`` records, each stage is also a span
``krisp:<name>`` over the same interval (``span``), so the trace puts the
card's idle time to the stage the host was in; with no profiler a span
costs one flag check.  ``profiler_trace`` (``--profile-dir``) records a
``torch.profiler`` trace in place of krisp_tpu's JAX profiler trace.
"""

from __future__ import annotations

import contextlib
import sys
import time
from collections import OrderedDict
from dataclasses import dataclass, field

import torch
from torch.profiler import record_function

#: prefix of a stage's span: the benchmark's own stage spans are
#: ``stage:<name>``, so the two never read as one another
SPAN_PREFIX = "krisp:"
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A ``torch.profiler`` span ``name`` over the ``with`` block while a
    profiler records, on the clock of the card's work in its trace; while
    none records, nothing."""
    if torch.autograd._profiler_enabled():
        return record_function(name)
    return _NO_SPAN


@dataclass
class StageStat:
    seconds: float = 0.0
    calls: int = 0
    items: int = 0

    def rate(self):
        return self.items / self.seconds if self.seconds > 0 else 0.0


@dataclass
class Metrics:
    stages: "OrderedDict[str, StageStat]" = field(default_factory=OrderedDict)

    @contextlib.contextmanager
    def stage(self, name: str, items: int = 0, device=None):
        stat = self.stages.setdefault(name, StageStat())
        with span(SPAN_PREFIX + name):
            t0 = time.perf_counter()
            try:
                yield stat
            finally:
                if device is not None and torch.device(device).type == "cuda":
                    torch.cuda.synchronize(device)
                stat.seconds += time.perf_counter() - t0
                stat.calls += 1
                stat.items += items

    def report(self, stream=None):
        stream = stream or sys.stderr
        width = max([len(n) for n in self.stages] + [5])
        for name, s in self.stages.items():
            rate = f"  {s.rate():,.0f} items/s" if s.items else ""
            print(f"  {name.ljust(width)} {s.seconds:8.3f}s"
                  f"  x{s.calls}{rate}", file=stream)

    def reset(self):
        self.stages.clear()


#: process-global registry used by the engine; the CLI reports it under
#: --verbose.
GLOBAL = Metrics()


@contextlib.contextmanager
def profiler_trace(log_dir: str | None, device=None):
    """Record a ``torch.profiler`` trace of the region into ``log_dir``
    (TensorBoard's plugin format, a ``*.pt.trace.json`` file) when it is
    set, with the card's kernels and copies when ``device`` is CUDA; a
    no-op otherwise."""
    if not log_dir:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
