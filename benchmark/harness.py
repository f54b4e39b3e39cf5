"""Runs one cell of BENCHMARK.json once: set-up, the measured window, the
check of every answer against the plain reference, and the metrics.

Everything that belongs to one configuration, traffic mix, entry or
metric is a file found by its name:

* ``BENCHMARK.json``'s ``configs[].file``: the configuration (its
  ``entry``, genome count and size, window, flags);
* ``traffic/<traffic>.json``: the mix's parameters, read by the one
  generator ``genomes.py``;
* ``entries/<entry>.py``: the program's entry point, its work count and
  its check;
* ``metrics/<metric>.py``: ``read(run) -> float | None``, the reader of
  one metric from the run's record (``Run``); None leaves the metric out.

The window runs searches back to back on the inputs set-up made and
closes at the end of the first search that ends after ``seconds``, so it
holds whole searches only.  ``--trace 1`` runs the same window under
``torch.profiler`` and reports the per-layer metrics in place of the
end-to-end ones.

The cell's ``chips`` reaches the program as ``--devices``.  A card counts
as used when its allocator served an allocation inside the window; a run
whose count of cards used differs from ``chips`` raises ``CardsUsed`` and
reports nothing.  The peak is the fullest card's; the trace's busy time
and idle gaps are each card's own, averaged over the cards.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path

import torch

from . import compare
from .trace import STAGE_PREFIX, WINDOW_SPAN, Trace

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
#: top-level modules that may not be loaded when the result is printed
FORBIDDEN = ("jax", "jaxlib", "flax", "krisp_tpu")


@dataclass
class Run:
    """What a metric reader reads."""
    setup_s: float
    window_s: float = 0.0
    work: int = 0                                   # k-mers over the window
    searches: list = field(default_factory=list)    # per search: wall_s,
    # work, stages {name: {"seconds", "calls", "items"}}
    stages: dict = field(default_factory=dict)      # summed over the window
    peak_bytes: int | None = None                   # the fullest card's
    card_peaks: list = field(default_factory=list)  # bytes, every card
    cards_used: list = field(default_factory=list)  # cards that allocated
    problem: dict = field(default_factory=dict)     # entry.problem()
    trace: Trace | None = None


class CardsUsed(RuntimeError):
    """The window used another number of cards than the cell asks for."""


def log(*parts):
    print(*parts, file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """Top-level names, compared whole, of loaded modules of JAX or of the
    JAX package."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load_manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_inputs(manifest: dict, name: str):
    """(cell, configuration, traffic) of the workload ``name``."""
    cell = next((w for w in manifest["workloads"] if w["name"] == name),
                None)
    if cell is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = next(c for c in manifest["configs"] if c["name"] == cell["config"])
    config = json.loads((ROOT / entry["file"]).read_text())
    traffic = json.loads((BENCH / "traffic"
                          / f"{cell['traffic']}.json").read_text())
    return cell, config, traffic


def cell_metrics(manifest: dict, name: str, kind: str) -> list[dict]:
    """The metrics of ``kind`` (``end_to_end`` or ``per_layer``) that the
    cell reports."""
    return [m for m in manifest[kind]
            if "workloads" not in m or name in m["workloads"]]


def load_reader(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def load_entry(name: str):
    return importlib.import_module(f"benchmark.entries.{name}").Entry


def _snapshot(metrics) -> dict:
    return {k: (s.seconds, s.calls, s.items) for k, s in metrics.stages.items()}


def _delta(after: dict, before: dict) -> dict:
    out = {}
    for k, (s, c, i) in after.items():
        s0, c0, i0 = before.get(k, (0.0, 0, 0))
        if c > c0:
            out[k] = {"seconds": s - s0, "calls": c - c0, "items": i - i0}
    return out


@contextlib.contextmanager
def _stage_spans(metrics):
    """Each of the program's stages inside a profiler span of its name,
    for the traced run alone."""
    from torch.profiler import record_function
    stage = metrics.stage

    @contextlib.contextmanager
    def traced(name, *args, **kwargs):
        with record_function(STAGE_PREFIX + name), \
                stage(name, *args, **kwargs) as stat:
            yield stat

    metrics.stage = traced
    try:
        yield
    finally:
        del metrics.stage


def _sync(device, chips: int = 1):
    """Wait for every card of the cell."""
    if torch.device(device).type == "cuda":
        for i in range(chips):
            torch.cuda.synchronize(i)


def _allocations() -> list[int]:
    """Allocations each card's allocator has served so far."""
    return [torch.cuda.memory_stats(i).get("allocation.all.allocated", 0)
            for i in range(torch.cuda.device_count())]


def _window_start() -> list[int]:
    """Every card's peak reset; the allocations served so far."""
    for i in range(torch.cuda.device_count()):
        torch.cuda.reset_peak_memory_stats(i)
    return _allocations()


def _window_end(run: Run, before: list[int]) -> None:
    """The cards that allocated inside the window (a tensor left over from
    set-up counts for nothing) and every card's peak, read with the cards
    in sync."""
    after = _allocations()
    run.cards_used = [i for i, (a, b) in enumerate(zip(before, after))
                      if b > a]
    run.card_peaks = [torch.cuda.max_memory_allocated(i)
                      for i in range(len(after))]
    run.peak_bytes = max(run.card_peaks)


def _window(entry, seconds: float, device, metrics, run: Run,
            chips: int = 1) -> int:
    """Searches back to back until one ends after ``seconds``; returns
    the searches that failed (the window stops at the first)."""
    start = time.perf_counter()
    i = 0
    while True:
        before = _snapshot(metrics)
        t0 = time.perf_counter()
        try:
            work = entry.search(f"search{i}")
            _sync(device, chips)
        except Exception:  # noqa: BLE001 - a failed search is reported
            log(traceback.format_exc())
            run.window_s = time.perf_counter() - start
            return 1
        t1 = time.perf_counter()
        run.searches.append({"wall_s": t1 - t0, "work": work,
                             "stages": _delta(_snapshot(metrics), before)})
        run.work += work
        i += 1
        if t1 - start >= seconds:
            run.window_s = t1 - start
            return 0


def _device_info(device, run: Run) -> dict:
    """The result's ``device``: the cards the window used, their one name
    and the fullest card's peak."""
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    names = sorted({torch.cuda.get_device_name(i) for i in run.cards_used})
    if len(names) > 1:
        raise CardsUsed(f"bench: the cards used differ: {names}")
    return {"platform": "gpu",
            "kind": names[0] if names else torch.cuda.get_device_name(0),
            "count": len(run.cards_used),
            "memory_peak_bytes": int(run.peak_bytes or 0)}


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    return out.stdout.strip() or "not read"


def run_cell(config: dict, traffic: dict, name: str, end_to_end: list,
             per_layer: list, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None,
             chips: int = 1) -> dict:
    """One run of one cell on ``chips`` cards; returns the result line's
    object.  ``t_start`` is the process's start on ``time.perf_counter``'s
    clock.  Raises ``CardsUsed`` where the window used another number of
    cards."""
    t_start = time.perf_counter() if t_start is None else t_start
    from krisp_tpu_torch import runtime
    from krisp_tpu_torch.metrics import GLOBAL as METRICS
    on_card = torch.device(device).type == "cuda"
    workdir = Path(tempfile.mkdtemp(prefix="krisp_bench_"))
    try:
        marks = [("imports", time.perf_counter())]
        if on_card:
            torch.zeros(1, device=device)   # the CUDA context
        runtime.setup(device)
        marks.append(("context+library", time.perf_counter()))
        entry = load_entry(config["entry"])(config, traffic, seed, workdir,
                                            device, chips)
        entry.setup()
        marks.append(("inputs", time.perf_counter()))
        entry.search("warmup")
        _sync(device, chips)
        marks.append(("warm-up", time.perf_counter()))
        run = Run(setup_s=marks[-1][1] - t_start, problem=entry.problem())
        parts = ", ".join(f"{k} {b - a:.3f}" for (_, a), (k, b)
                          in zip([("", t_start)] + marks, marks))
        log(f"bench: {name} seed {seed}: set-up {run.setup_s:.3f} s "
            f"({parts})")

        METRICS.reset()
        allocations = _window_start() if on_card else []
        cpu0 = time.process_time()
        failed = 0
        if trace:
            from torch.profiler import ProfilerActivity, profile, \
                record_function
            acts = [ProfilerActivity.CPU]
            if on_card:
                acts.append(ProfilerActivity.CUDA)
            with profile(activities=acts) as prof, _stage_spans(METRICS):
                with record_function(WINDOW_SPAN):
                    failed = _window(entry, seconds, device, METRICS, run,
                                     chips)
            path = workdir / "trace.json"
            prof.export_chrome_trace(str(path))
            del prof
            run.trace = Trace.load(path, chips)
            path.unlink()
        else:
            failed = _window(entry, seconds, device, METRICS, run, chips)
        run.stages = _delta(_snapshot(METRICS), {})
        cpu_s = time.process_time() - cpu0
        if on_card:
            _sync(device, chips)
            _window_end(run, allocations)
        walls = [s["wall_s"] for s in run.searches]
        if walls:
            log(f"bench: {len(walls)} searches in {run.window_s:.4f} s; "
                f"a search: median {statistics.median(walls):.4f} s, "
                f"slowest {max(walls):.4f} s; process CPU {cpu_s:.4f} s")
            log("bench: stage seconds over the window: " + ", ".join(
                f"{k} {v['seconds']:.4f}" for k, v in run.stages.items()))
        if on_card:
            log(f"bench: card {_power_limit()}")
            log(f"bench: cards used {run.cards_used} of "
                f"{len(run.card_peaks)}; peaks {run.card_peaks} bytes")
        info = _device_info(device, run)
        if info["count"] != chips:
            raise CardsUsed(
                f"bench: the cell asks for {chips} card(s), cards "
                f"{list(range(chips))}; the window used {info['count']}: "
                f"cards {run.cards_used} of {len(run.card_peaks) or 1}")

        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        numbers, facts = entry.check(device)
        log(f"bench: reference {time.perf_counter() - t0:.3f} s, {facts}")
        ok = (failed == 0 and bool(run.searches) and facts["csv_rows"] > 0
              and compare.passed(numbers))

        metrics = {}
        for m in (per_layer if trace else end_to_end):
            value = load_reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result = {"correct": ok, "attempted": len(run.searches) + failed,
                  "failed": failed, "metrics": metrics,
                  "device": info}
        if trace and run.trace is not None:
            result["device"]["busy_s"] = run.trace.busy_s
            result["device"]["window_s"] = run.trace.window_s
            result["breakdown"] = {"device_ops": run.trace.device_ops(),
                                   "idle_gaps": run.trace.idle_gaps()}
        result["checks"] = compare.checks(numbers)
        return result
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def print_result(result: dict) -> None:
    """The check's numbers as the last lines of standard error, then the
    result as the last line of standard output."""
    for k, v in result["checks"].items():
        log(f"check {k} {v['value']} limit {v['limit']}")
    print(json.dumps(result), flush=True)
