"""The traced run's device timeline, read from a ``torch.profiler`` trace
exported as Chrome trace JSON.

The harness names the measured window with a span (``WINDOW_SPAN``) and,
in a traced run only, each of the program's stages with a span
``stage:<name>`` around it, so an idle stretch of the card can be put to
what the host was doing then.  Times are microseconds of the trace's one
clock, host and device alike.

Over several cards each device operation keeps its card (the event's
``args.device``, else its ``pid``): busy time and idle gaps are each
card's own, averaged over the cards, while ``kernel_seconds`` and
``device_ops`` sum every launch on every card (card-seconds).
"""

from __future__ import annotations

import json
import re
from pathlib import Path

import numpy as np

WINDOW_SPAN = "bench:window"
STAGE_PREFIX = "stage:"
DEVICE_CATEGORIES = {"kernel", "gpu_memcpy", "gpu_memset"}
_KERNEL = re.compile(r"^(?:void\s+)?(?:\(anonymous namespace\)::)?"
                     r"([A-Za-z_]\w*)\s*(?:[<(]|$)")


def kernel_id(name: str) -> str | None:
    """The function name of a kernel of the program's own sources (an
    unqualified or anonymous-namespace ``__global__``), else None: a
    library's kernels are qualified (``at::native::``, ``cub::``)."""
    m = _KERNEL.match(name)
    return m.group(1) if m else None


def short_name(name: str) -> str:
    return kernel_id(name) or name[:80]


def _merge(intervals):
    """Union of (start, end) intervals, sorted."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _card(event):
    """The card of a device event: its ``args.device``, else its ``pid``."""
    args = event.get("args") or {}
    return args.get("device", event.get("pid"))


class Trace:
    """Device operations and host spans of one traced window, over
    ``cards`` cards (at least those that the trace's operations ran on)."""

    def __init__(self, events, cards: int = 1):
        self.device, self.spans = [], []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            iv = (str(e.get("name", "")), float(e["ts"]),
                  float(e["ts"]) + float(e["dur"]))
            if e.get("cat") in DEVICE_CATEGORIES:
                self.device.append(iv + (_card(e),))
            elif e.get("cat") == "user_annotation":
                self.spans.append(iv)
        windows = [s for s in self.spans if s[0] == WINDOW_SPAN]
        if windows:
            self.start, self.end = windows[0][1], windows[0][2]
        elif self.device:
            self.start = min(d[1] for d in self.device)
            self.end = max(d[2] for d in self.device)
        else:
            self.start = self.end = 0.0
        self.device = [(n, max(a, self.start), min(b, self.end), c)
                       for n, a, b, c in self.device
                       if b > self.start and a < self.end]
        #: the cards that ran an operation in the window, in order of use
        self.card_ids = list(dict.fromkeys(c for *_, c in self.device))
        self.cards = max(int(cards), len(self.card_ids))

    @classmethod
    def load(cls, path, cards: int = 1) -> "Trace":
        data = json.loads(Path(path).read_text())
        return cls(data["traceEvents"] if isinstance(data, dict) else data,
                   cards)

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    def busy_intervals(self, card):
        """Union of one card's device operations, sorted."""
        return _merge((a, b) for _, a, b, c in self.device if c == card)

    @property
    def busy_s(self) -> float:
        """Seconds of the window in which an operation ran on a card, each
        card's own, averaged over the cards."""
        return sum(sum(b - a for a, b in self.busy_intervals(c)) / 1e6
                   for c in self.card_ids) / self.cards

    def kernel_seconds(self, names) -> float:
        """Device seconds of the kernels whose function name is in
        ``names`` (each launch's own duration, summed over every card)."""
        names = set(names)
        return sum(b - a for n, a, b, _ in self.device
                   if kernel_id(n) in names) / 1e6

    def device_ops(self, top: int = 10):
        """[name, seconds] of the device operations that took most time
        (card-seconds)."""
        total: dict = {}
        for n, a, b, _ in self.device:
            k = short_name(n)
            total[k] = total.get(k, 0.0) + (b - a) / 1e6
        return [[k, v] for k, v in
                sorted(total.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10):
        """[what the host was doing, seconds] of the cards' idle time in
        the window: each card's idle stretches split among the stage spans
        over them (the program's stages do not nest), the rest "outside
        stages", summed over the cards and divided by their count.  A card
        that ran nothing is idle all through the window."""
        total: dict = {}
        idle = [self._gaps(self.busy_intervals(c)) for c in self.card_ids]
        idle += [self._gaps([])] * (self.cards - len(self.card_ids))
        for gaps in idle:
            for k, v in gaps.items():
                total[k] = total.get(k, 0.0) + v
        total = {k: v / self.cards for k, v in total.items()}
        return [[k, v] for k, v in
                sorted(total.items(), key=lambda kv: -kv[1])[:top] if v > 0]

    def _gaps(self, busy) -> dict:
        """{what the host was doing: seconds} of one card's idle time."""
        edges = [self.start] + [x for iv in busy for x in iv] + [self.end]
        gaps = np.array([(a, b) for a, b in zip(edges[::2], edges[1::2])
                         if b > a], dtype=np.float64).reshape(-1, 2)
        stages = [s for s in self.spans if s[0].startswith(STAGE_PREFIX)]
        total: dict = {}
        covered = np.zeros(len(gaps))
        if stages and len(gaps):
            s = np.array([(a, b) for _, a, b in stages])
            over = np.clip(np.minimum(gaps[:, None, 1], s[None, :, 1])
                           - np.maximum(gaps[:, None, 0], s[None, :, 0]),
                           0, None)
            covered = over.sum(1)
            for (name, _, _), sec in zip(stages, over.sum(0) / 1e6):
                key = name[len(STAGE_PREFIX):]
                total[key] = total.get(key, 0.0) + sec
        rest = np.clip(gaps[:, 1] - gaps[:, 0] - covered, 0, None).sum()
        total["outside stages"] = rest / 1e6
        return total
