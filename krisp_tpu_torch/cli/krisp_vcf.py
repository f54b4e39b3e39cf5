"""`krisp_vcf` command-line front-end.

Flag-surface parity with the reference CLI
(reference src/krisp/krisp_vcf/krisp_vcf.py:919-990) and its driver
(run_all, krisp_vcf.py:1320-1388): logging setup, reference/metadata parsing,
contig chunking, serial or worker-pool scanning with a single-writer
aggregator and failure propagation.

The port's copy of ``krisp_tpu/cli/krisp_vcf.py``, plus the port's
``--device {cuda,cpu}`` (default cuda): where the device engine classifies.
It is taken off before ``parse_args``, so ``args`` (and the ``--resume``
fingerprint) are krisp_tpu's, and it is passed down as an argument.  Run it
as ``python -m krisp_tpu_torch.cli.krisp_vcf ...``.
"""

from __future__ import annotations

import argparse
import gzip
import logging
import multiprocessing as mp
import os
import queue as queue_mod
import sys
from contextlib import contextmanager

from ._pipe import pipe_safe

logger = logging.getLogger("krisp_tpu_torch.krisp_vcf")


def parse_args(argv):
    p = argparse.ArgumentParser(
        description="Find regions where there are conserved variants for "
                    "each group that are not found in other groups.")
    p.add_argument("metadata", type=str, metavar="METADATA")
    p.add_argument("reference", type=str, metavar="REFERENCE")
    p.add_argument("--vcf", type=str, default="-", metavar="PATH")
    p.add_argument("--sample_col", type=str, default="sample_id", metavar="TEXT")
    p.add_argument("--group_col", type=str, default="group", metavar="TEXT")
    p.add_argument("--index", type=str, metavar="PATH",
                   help="byte-offset index sidecar: written on first run, "
                        "reused while the VCF is unchanged (skips the "
                        "indexing pass; for gzip input the decompressed "
                        "copy persists at PATH.vcf). The tabix-index "
                        "equivalent of the reference CLI.")
    p.add_argument("--groups", type=str, nargs="+", metavar="TEXT")
    p.add_argument("--out_csv", type=str, metavar="PATH")
    p.add_argument("--out_align", type=str, metavar="PATH")
    p.add_argument("--chroms", type=str, nargs="+", metavar="TEXT")
    p.add_argument("--pos", type=int, nargs=2, metavar="INT", default=None)
    p.add_argument("--min_samples", type=int, default=3, metavar="INT")
    p.add_argument("--min_samp_prop", type=float, default=0.9, metavar="PROP")
    p.add_argument("--min_reads", type=int, default=10, metavar="INT")
    p.add_argument("--min_geno_qual", type=int, default=40, metavar="INT")
    p.add_argument("--min_var_qual", type=int, default=10, metavar="INT")
    p.add_argument("--min_freq", type=float, default=0.1, metavar="PROP")
    p.add_argument("--min_map_qual", type=int, default=40, metavar="INT")
    p.add_argument("--min_bases", type=int, default=1, metavar="INT")
    p.add_argument("--cores", type=int, default=1, metavar="INT")
    p.add_argument("--log", type=str, metavar="PATH")
    p.add_argument("--log_level", type=str,
                   choices=["DEBUG", "INFO", "WARNING", "ERROR", "CRITICAL"])
    p.add_argument("--var_location", type=int, nargs=2, metavar="INT",
                   default=[6, 14])
    p.add_argument("--crrna_len", type=int, default=28, metavar="INT")
    p.add_argument("--tm", type=int, nargs=2, metavar="INT", default=[53, 68])
    p.add_argument("--gc", type=int, nargs=2, metavar="INT", default=[40, 70])
    p.add_argument("--amp_size", type=int, nargs=2, metavar="INT",
                   default=[70, 150])
    p.add_argument("--primer_size", type=int, nargs=2, metavar="INT",
                   default=[25, 35])
    p.add_argument("--max_sec_tm", type=int, default=40, metavar="INT")
    p.add_argument("--gc_clamp", type=int, default=1, metavar="INT")
    p.add_argument("--max_end_gc", type=int, default=4, metavar="INT")
    p.add_argument("--force", action="store_true", default=False)
    p.add_argument("--resume", action="store_true", default=False,
                   help="Continue an interrupted scan from its last "
                        "completed chunk (requires --out_csv; progress is "
                        "tracked in <out_csv>.progress). The finished "
                        "outputs are byte-identical to an uninterrupted "
                        "run.")
    p.add_argument("--engine", type=str, choices=["auto", "host", "device"],
                   default="auto",
                   help="Variant classification engine: exact host path or "
                        "TPU-batched kernel with on-demand exact "
                        "rehydration; 'auto' picks the device path for "
                        "large indexed VCFs. (default: %(default)s)")
    p.add_argument("--devices", type=int, default=None, metavar="INT",
                   help="Number of accelerator devices to shard the device "
                        "engine's classification batches over (default: "
                        "all; same as KRISP_TPU_DEVICES)")
    return p.parse_args(argv)


def configure_logger(args=None, mode="w"):
    log = logging.getLogger("krisp_tpu_torch.krisp_vcf")
    log.setLevel(logging.DEBUG)
    log.handlers.clear()
    stderr_handler = logging.StreamHandler()
    stderr_handler.setLevel(logging.WARNING)
    fmt = logging.Formatter("%(levelname)s: %(name)s: %(message)s")
    stderr_handler.setFormatter(fmt)
    log.addHandler(stderr_handler)
    if args is not None:
        if args.log is None:
            stderr_handler.setLevel(args.log_level or "WARNING")
        else:
            fh = logging.FileHandler(filename=args.log, mode=mode)
            fh.setLevel(args.log_level or "INFO")
            fh.setFormatter(fmt)
            log.addHandler(fh)
    return log


def parse_reference(path):
    """Reference FASTA -> {record id: sequence str}
    (parity: krisp_vcf.py:482-494)."""
    if path is None:
        return None
    opener = gzip.open if path.endswith(".gz") else open
    reference = {}
    name = None
    chunks = []
    with opener(path, "rt") as handle:
        for line in handle:
            line = line.strip()
            if line.startswith(">"):
                if name is not None:
                    reference[name] = "".join(chunks)
                name = line[1:].split()[0]
                chunks = []
            else:
                chunks.append(line)
    if name is not None:
        reference[name] = "".join(chunks)
    return reference


@contextmanager
def stream_writer(file_path=None, default_stream=sys.stdout, mode="w"):
    handle = default_stream if file_path is None else open(file_path, mode)
    try:
        yield handle
    finally:
        if file_path is not None:
            handle.close()


SEARCH_ARG_NAMES = ("min_samples", "min_reads", "min_geno_qual",
                    "min_map_qual", "min_var_qual", "min_freq",
                    "min_samp_prop", "var_location", "crrna_len", "tm", "gc",
                    "primer_size", "amp_size", "max_sec_tm", "min_bases",
                    "gc_clamp", "max_end_gc", "force", "engine")


def _worker(result_queue, log_queue, failure_event, vcf_path, chunk, groups,
            reference, want_alignment, search_args, device):
    from logging.handlers import QueueHandler
    from ..vcf.report import report_diag_region

    # route worker logs through the parent's single-writer drain
    # (parity: configure_subprocess_logger, krisp_vcf.py:91-98)
    log = logging.getLogger("krisp_tpu_torch.krisp_vcf")
    log.handlers.clear()
    log.addHandler(QueueHandler(log_queue))
    log.setLevel(logging.DEBUG)
    try:
        log.info(f"Starting scan of chunk {chunk}")
        for result in report_diag_region(vcf_path, chunk, groups, reference,
                                         want_alignment, device=device,
                                         **search_args):
            if failure_event.is_set():
                log.critical("Error detected in other worker process. "
                             "Ending this process too.")
                return
            result_queue.put(result)
        result_queue.put("chunk_done")
    except BaseException:
        log.exception(f"Error scanning chunk {chunk}")
        failure_event.set()
        result_queue.put("chunk_done")
        raise


def run_all(args, device="cuda"):
    from ..metrics import GLOBAL as METRICS
    from ..vcf.classify import parse_group_data
    from ..vcf.report import make_chunks

    global logger
    logger = configure_logger(args)
    lines = [f"    {k:<15}: {v}" for k, v in vars(args).items()
             if v is not None]
    logger.info("\n".join(["Parameters used:"] + lines))

    reference = parse_reference(args.reference)
    groups = parse_group_data(args.metadata, groups=args.groups,
                              sample_col=args.sample_col,
                              group_col=args.group_col,
                              min_samples=args.min_samples)
    search_args = {k: v for k, v in vars(args).items()
                   if k in SEARCH_ARG_NAMES}
    search_args["var_location"] = tuple(search_args["var_location"])
    for k in ("tm", "gc", "amp_size", "primer_size"):
        search_args[k] = tuple(search_args[k])

    group_names = args.groups if args.groups else list(groups.keys())
    want_alignment = args.out_align is not None

    vcf_source = args.vcf
    vcf_index = None
    if args.vcf == "-":
        chunks = [None]
    else:
        # one streaming pass: decompress (if gzip) + byte-offset index;
        # contig discovery falls out of the same pass and every chunk fetch
        # afterwards is a seek (replaces tabix, krisp_vcf.py:1016-1042)
        from ..vcf.parser import VcfOffsetIndex
        with METRICS.stage("vcf_index"):
            vcf_index = VcfOffsetIndex(args.vcf, sidecar=args.index)
        if args.index:
            logger.info("index sidecar %s: %s" % (
                args.index, "reused" if vcf_index.loaded_from_sidecar
                else "written"))
        vcf_source = vcf_index
        contigs = [c for c, _ in vcf_index.contigs]
        chunks = make_chunks(reference, contigs, chunk_size=100000,
                             flank_size=1000, contig_subset=args.chroms,
                             pos_subset=args.pos)
        if search_args.get("engine") == "auto":
            # resolve 'auto' against the records the scan will actually
            # touch, not the whole file: a --pos/--chroms slice of a big
            # VCF should not pay the device engine's compile latency
            from ..vcf.report import AUTO_DEVICE_MIN_RECORDS
            est = sum(vcf_index.n_records_in(c["contig"], c.get("start"),
                                             c.get("end"))
                      for c in chunks if c)
            search_args["engine"] = ("device"
                                     if est >= AUTO_DEVICE_MIN_RECORDS
                                     else "host")
            logger.info(f"Engine auto -> {search_args['engine']} "
                        f"(~{est} records in scan range)")

    try:
        _scan_chunks(args, chunks, vcf_source, groups, reference,
                     group_names, want_alignment, search_args, device)
    finally:
        if vcf_index is not None:
            vcf_index.cleanup()


def _scan_chunks(args, chunks, vcf_source, groups, reference, group_names,
                 want_alignment, search_args, device="cuda"):
    from ..vcf.report import (ResultWriter, report_diag_region,
                              uses_device_fast_path)

    resume = getattr(args, "resume", False)
    if resume and not args.out_csv:
        raise SystemExit("--resume requires --out_csv (stdout cannot be "
                         "truncated back to a chunk boundary)")

    multicore = args.vcf != "-" and args.cores > 1 and not resume
    if resume and args.cores > 1:
        # the worker pool writes results in arrival order, which has no
        # stable chunk boundaries to checkpoint; resumable scans run the
        # in-process loop (long scans use the device engine, which is
        # in-process anyway)
        logger.info("--resume: scanning in-process "
                    "(--cores applies to non-resumable runs)")
    if multicore and uses_device_fast_path(vcf_source, search_args):
        # The device engine scans the whole file in one process (columnar
        # parse + compiled programs are cached per process); forking a spawn
        # worker per 100kb chunk would re-parse the file and re-initialize
        # the accelerator once per chunk.  --cores parallelism applies to
        # the host engine.
        logger.info("Device engine selected: scanning in-process on the "
                    "accelerator (--cores applies to the host engine)")
        multicore = False

    if multicore:
        ctx = mp.get_context("spawn")
        manager = ctx.Manager()
        failure_event = manager.Event()
        result_queue = manager.Queue()
        log_queue = manager.Queue()

        def drain_logs():
            while True:
                try:
                    record = log_queue.get(block=False)
                    logger.handle(record)
                except queue_mod.Empty:
                    return

        with stream_writer(args.out_csv, sys.stdout) as out_stream:
            writer = ResultWriter(out_stream, group_names,
                                  align_path=args.out_align)
            pending = list(chunks)
            active = []
            done = 0
            while done < len(chunks):
                while pending and len(active) < args.cores:
                    chunk = pending.pop(0)
                    proc = ctx.Process(
                        target=_worker,
                        args=(result_queue, log_queue, failure_event,
                              vcf_source, chunk, groups, reference,
                              want_alignment, search_args, device))
                    proc.start()
                    active.append(proc)
                drain_logs()
                try:
                    item = result_queue.get(timeout=0.2)
                except queue_mod.Empty:
                    active = [p for p in active if p.is_alive()]
                    continue
                if item == "chunk_done":
                    done += 1
                    active = [p for p in active if p.is_alive()]
                else:
                    writer.write(item)
            for proc in active:
                proc.join()
            drain_logs()
            writer.finish()
        logger.info("Total variants scanned: " + str(writer.total_variants()))
    else:
        progress = None
        csv_mode, align_mode = "w", "w"
        if resume:
            from ..vcf.resume import ScanProgress
            progress = ScanProgress(args.out_csv, args, chunks)
            if progress.load():
                progress.truncate_outputs(args.out_csv, args.out_align)
                csv_mode = align_mode = "a"
                logger.info(f"Resuming at chunk {progress.next_chunk}/"
                            f"{progress.n_chunks}")
        with stream_writer(args.out_csv, sys.stdout,
                           mode=csv_mode) as out_stream:
            writer = ResultWriter(out_stream, group_names,
                                  align_path=args.out_align,
                                  align_mode=align_mode)
            if progress is not None:
                progress.restore_writer(writer)
            for ci, chunk in enumerate(chunks):
                if progress is not None and ci < progress.next_chunk:
                    continue
                for result in report_diag_region(vcf_source, chunk, groups,
                                                 reference, want_alignment,
                                                 device=device,
                                                 **search_args):
                    writer.write(result)
                if progress is not None:
                    progress.mark_done(ci, writer)
            writer.finish()
        if progress is not None:
            progress.finish()
        logger.info("Total variants scanned: " + str(writer.total_variants()))



@pipe_safe
def main(argv=None):
    from ..device import split_device_flag

    device, rest = split_device_flag(sys.argv[1:] if argv is None else argv)
    args = parse_args(rest)
    if args.devices is not None:
        os.environ["KRISP_TPU_DEVICES"] = str(args.devices)
    run_all(args, device)
    return 0


if __name__ == "__main__":
    main()
