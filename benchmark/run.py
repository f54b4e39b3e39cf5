"""Run one cell of BENCHMARK.json once, on the card this process is started
on:

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Prints the result as the last line of standard output (README.md).  The
program runs on the cell's ``chips`` cards (``--devices``).  Exits with a
code other than 0 and prints no result where there is no CUDA card, fewer
cards than the cell asks for, a window that used another number of cards
than it asks for, no ``krisp_tpu_torch`` beside this folder, or a module
of JAX or of the JAX package loaded at the end.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the checkout's root, not this folder, heads the module path
sys.path[0] = str(ROOT)
# build and kernel caches at fixed places inside the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(ROOT / "_bench_cache" / sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "krisp_tpu_torch" / "__init__.py").exists():
        print(f"bench: no krisp_tpu_torch in {ROOT}", file=sys.stderr)
        return 2
    from benchmark import harness
    manifest = harness.load_manifest()
    cell, config, traffic = harness.cell_inputs(manifest, args.workload)

    import torch
    if not torch.cuda.is_available():
        print("bench: torch.cuda.is_available() is false", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell["chips"]:
        print(f"bench: {torch.cuda.device_count()} cards, the cell asks for "
              f"{cell['chips']}", file=sys.stderr)
        return 3
    import krisp_tpu_torch
    if Path(krisp_tpu_torch.__file__).resolve().parent.parent != ROOT:
        print(f"bench: krisp_tpu_torch loaded from {krisp_tpu_torch.__file__},"
              f" not from {ROOT}", file=sys.stderr)
        return 2

    try:
        result = harness.run_cell(
            config, traffic, args.workload,
            harness.cell_metrics(manifest, args.workload, "end_to_end"),
            harness.cell_metrics(manifest, args.workload, "per_layer"),
            args.seed, args.seconds, bool(args.trace), "cuda", T_START,
            cell["chips"])
    except harness.CardsUsed as e:
        print(e, file=sys.stderr)
        return 5
    found = harness.forbidden_modules()
    if found:
        print(f"bench: modules of JAX or krisp_tpu loaded: {found}",
              file=sys.stderr)
        return 4
    harness.print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
