"""Per-stage wall timers (the ``krisp_tpu.metrics`` API).

A stage given a CUDA ``device`` synchronises that device at its end, so its
wall time covers the device work it queued and not only the enqueue.
Profiler traces (``--profile-dir``) are not ported yet.
"""

from __future__ import annotations

import contextlib
import sys
import time
from collections import OrderedDict
from dataclasses import dataclass, field

import torch


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
