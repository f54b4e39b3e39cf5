"""A/B of the row sort against sorted runs plus a merge (the port of
``tools/ab_merge_path.py``):

  A) ``sort_words`` of 2n two-word keys;
  B) ``sort_words`` of each n-key half, then ``merge_sorted_words`` of the
     two sorted halves.

Arm B's sorts are independent, so on several cards they could run side by
side; on one card the question is whether the merge costs less than the
sort work it displaces.

    python -m krisp_tpu_torch.tools.ab_merge_path [--n 20000000] [--reps 5]
        [--device {cuda,cpu}]

Prints one JSON line: best-of-``reps`` seconds of each step after one
warm-up (the card synchronised around each), and whether arm B's table
equals arm A's bit for bit.  ``--device cpu`` runs the plain versions.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..convert import keys_from_numpy
from ..device import resolve_device
from ..ops.merge import merge_sorted_words
from ..ops.sort import sort_words


def ab_keys(n: int) -> np.ndarray:
    """The JAX tool's keys: 2n random u63 keys from seed 5 as (hi, lo)
    uint32 words."""
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 2**63, 2 * n, dtype=np.uint64)
    return np.stack([(keys >> 32).astype(np.uint32), keys.astype(np.uint32)])


def _best(fn, reps: int, dev):
    """(output, best seconds of ``reps`` calls after one warm-up)."""
    def call():
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out

    out = call()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = call()
        best = min(best, time.perf_counter() - t0)
    return out, best


def run(n: int = 20_000_000, reps: int = 5, device="cuda") -> dict:
    """Both arms on ``device``; returns the JAX tool's JSON keys (seconds
    unrounded) plus the device's name."""
    dev = resolve_device(device)
    words = keys_from_numpy(ab_keys(n), dev)
    half_a, half_b = words[:, :n].contiguous(), words[:, n:].contiguous()
    sorted_all, t_big = _best(lambda: sort_words(words), reps, dev)
    sorted_a, t_a = _best(lambda: sort_words(half_a), reps, dev)
    sorted_b, t_b = _best(lambda: sort_words(half_b), reps, dev)
    merged, t_merge = _best(lambda: merge_sorted_words(sorted_a, sorted_b),
                            reps, dev)
    t_b_arm = t_a + t_b + t_merge
    return {
        "metric": "merge_path_ab",
        "n_total": 2 * n,
        "unit": "seconds",
        "sort_2n_s": t_big,
        "sort_n_s": t_a,
        "sort_n2_s": t_b,
        "merge_s": t_merge,
        "b_total_s": t_b_arm,
        "b_vs_a": t_b_arm / t_big,
        "merge_mkeys_per_s": 2 * n / t_merge / 1e6,
        "bit_parity": bool(torch.equal(merged, sorted_all)),
        "backend": dev.type,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=20_000_000,
                    help="keys per run; total = 2n")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.n, args.reps, args.device)))
    return 0


if __name__ == "__main__":
    main()
