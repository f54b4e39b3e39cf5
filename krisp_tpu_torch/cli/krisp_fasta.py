"""`krisp_fasta` on the PyTorch port.

Takes krisp_tpu's flag surface (``parse_args``, ``_open_out`` and
``_design_job`` are copies of ``krisp_tpu/cli/krisp_fasta.py``'s) plus
``--device {cuda,cpu}`` (default cuda), and writes the same outputs
through the port's engine: spacer geometries (``--conserved-left 25
--conserved-right 2 --diagnostic 1``), amplicons (``--conserved 30
--amplicon 100``, wide keys through the prefix prefilter) and inputs with
IUPAC letters (4-bit keys); ``--devices N`` shards the search over N cards
and ``--profile-dir DIR`` records a ``torch.profiler`` trace of it.  Run
it as ``python -m krisp_tpu_torch.cli.krisp_fasta ...``.

A search, from its geometry to the last file closed, is one span
``krisp_fasta`` in a profiler's trace, with a span ``krisp:<stage>`` for
each of its stages inside it; the CSV and alignment writes are stage
``render`` (items: groups written).
"""

from __future__ import annotations

import argparse
import gzip
import sys
import time

from ._pipe import pipe_safe


def parse_args(argv):
    parser = argparse.ArgumentParser(
        description="Find diagnostic alignments for a set of fasta files",
        prog="krisp_fasta",
        formatter_class=argparse.RawTextHelpFormatter)
    parser.add_argument("files", nargs="+", type=str, metavar="PATH",
                        help="Fasta file to read. .gz, .bz2")
    parser.add_argument("--outgroup", nargs="*", type=str, default=[],
                        metavar="PATH",
                        help="Outgroup Fasta files. To be amplified, but not detected")
    parser.add_argument("-c", "--conserved", type=int, metavar="INT",
                        help="Length of conserved regions on ends of amplicon")
    parser.add_argument("--conserved-left", type=int, metavar="INT",
                        help="Length of conserved region on left of amplicon")
    parser.add_argument("--conserved-right", type=int, metavar="INT",
                        help="Length of conserved region on right of amplicon")
    parser.add_argument("-d", "--diagnostic", type=int, metavar="INT",
                        help="Diagnostic region length for amplicon")
    parser.add_argument("-a", "--amplicon", type=int, metavar="INT",
                        help="Total amplicon length")
    parser.add_argument("--omit-soft", action="store_true",
                        help="Omit softmasked nucleotides")
    parser.add_argument("--cores", type=int, default=1, metavar="INT",
                        help="Total number of processors to utilize. (default: %(default)s)")
    parser.add_argument("--devices", type=int, default=None, metavar="INT",
                        help="Number of accelerator devices to shard the"
                             " intersection over (default: all available)")
    parser.add_argument("--dot-alignment", action="store_true",
                        help="Output as dot-based alignments")
    parser.add_argument("-o", "--out_align", type=str, metavar="PATH",
                        help="Write results as human-readable alignments to a file (gzip supported)")
    parser.add_argument("-s", "--out_csv", type=str, metavar="PATH",
                        help="Write results to as a CSV file (gzip supported). (default: stdout)")
    parser.add_argument("-w", "--workdir", type=str, metavar="PATH",
                        help="Work directory for per-genome k-mer table checkpoints (resume support)")
    parser.add_argument("-p", "--primer3", action=argparse.BooleanOptionalAction,
                        help="Score candidate regions with the primer design engine")
    parser.add_argument("--tm", type=int, nargs=2, metavar="INT", default=[53, 68])
    parser.add_argument("--gc", type=int, nargs=2, metavar="INT", default=[40, 70])
    parser.add_argument("--amp_size", type=int, nargs=2, metavar="INT", default=[70, 150])
    parser.add_argument("--primer_size", type=int, nargs=2, metavar="INT", default=[25, 35])
    parser.add_argument("--max_sec_tm", type=int, default=40, metavar="INT")
    parser.add_argument("--gc_clamp", type=int, default=1, metavar="INT")
    parser.add_argument("--max_end_gc", type=int, default=4, metavar="INT")
    parser.add_argument("--verbose", action="store_true",
                        help="Print runtime information to sys.stderr")
    parser.add_argument("--profile-dir", type=str, metavar="PATH",
                        help="Capture a torch.profiler trace (TensorBoard "
                             "plugin format) of the whole search into this "
                             "directory")
    return parser.parse_args(argv)


def _design_job(task, p3_args):
    """Pool worker: score one consensus template."""
    from ..thermo.design import run_primer3
    template, target_start, target_len = task
    return run_primer3(template, target_start=target_start,
                       target_len=target_len, **p3_args)


def _open_out(path, default):
    if path is None:
        return default, False
    if path.endswith(".gz"):
        return gzip.open(path, "wt"), True
    return open(path, "w"), True


@pipe_safe
def main(argv=None):
    from ..device import split_device_flag
    from ..engine import render
    from ..engine.pipeline import run_pipeline, solve_geometry
    from ..metrics import GLOBAL as METRICS
    from ..metrics import profiler_trace, span
    from ..runtime import setup as _setup_runtime

    device, rest = split_device_flag(sys.argv[1:] if argv is None else argv)
    _setup_runtime(device)
    args = parse_args(rest)
    try:
        geom = solve_geometry(amplicon=args.amplicon,
                              diagnostic=args.diagnostic,
                              conserved=args.conserved,
                              conserved_left=args.conserved_left,
                              conserved_right=args.conserved_right)
    except ValueError:
        print("ERROR: Could not deduce input parameters", file=sys.stderr)
        sys.exit(1)

    start_t = time.time()
    if args.verbose:
        print("Finding kmer-based diagnostic regions for:", file=sys.stderr)
        for i, f in enumerate(args.files):
            print(f"({i}) {f}", file=sys.stderr)
        print("With this as an outgroup:", file=sys.stderr)
        for i, f in enumerate(args.outgroup):
            print(f"({i}) {f}", file=sys.stderr)
        print(file=sys.stderr)

    with profiler_trace(args.profile_dir, device), span("krisp_fasta"):
        groups = run_pipeline(args.files, args.outgroup, geom,
                              omit_soft=args.omit_soft, workdir=args.workdir,
                              n_devices=args.devices, device=device)

        p3_args = dict(tm=tuple(args.tm), gc=tuple(args.gc),
                       amp_size=tuple(args.amp_size),
                       primer_size=tuple(args.primer_size),
                       max_sec_tm=args.max_sec_tm, gc_clamp=args.gc_clamp,
                       max_end_gc=args.max_end_gc)

        out_csv, close_csv = _open_out(args.out_csv, sys.stdout)
        out_align, close_align = _open_out(args.out_align, None)

        if args.primer3:
            from ..thermo.design import design_primers_for_group
            with METRICS.stage("primer3", items=len(groups)):
                if args.cores > 1 and len(groups) > 1:
                    import multiprocessing as mp
                    ctx = mp.get_context("spawn")
                    tasks = []
                    for group in groups:
                        consensus = group.ingroup_consensus()
                        tasks.append(("".join(consensus.values()),
                                      len(consensus["forward"]),
                                      len(consensus["diagnostic"])))
                    with ctx.Pool(min(args.cores, len(groups))) as pool:
                        results = pool.starmap(
                            _design_job, [(t, p3_args) for t in tasks])
                    for group, p3 in zip(groups, results):
                        group.p3 = p3
                else:
                    for group in groups:
                        design_primers_for_group(group, **p3_args)
            groups = [g for g in groups
                      if g.p3["PRIMER_PAIR_NUM_RETURNED"] != 0]

        with METRICS.stage("render", items=len(groups)):
            print(render.csv_header(primer3=bool(args.primer3)),
                  file=out_csv)
            for group in groups:
                print(render.render_csv(group), file=out_csv)
                if out_align is not None:
                    print(render.render_alignment(
                        group, enable_dot=args.dot_alignment), file=out_align)
            if close_csv:
                out_csv.close()
            if out_align is not None and close_align:
                out_align.close()

    if args.verbose:
        dt = time.time() - start_t
        print("Stage timings:", file=sys.stderr)
        METRICS.report()
        print(f"=> Found {len(groups):,} regions in {dt:.2f} seconds",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    main()
