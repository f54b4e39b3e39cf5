"""Device-batched variant classification for the scan pipeline.

The port's copy of ``krisp_tpu/vcf/device_classify.py``; only
``classify_stream_device`` differs: it runs the port's torch
``classify_batch`` on an explicit ``device``.

The cascade only needs allele-count/conserved/diagnostic values for every
variant (cheap to batch on device, ops/vcfclass.py); the exact host
classification (ordered dicts, missing-sample ids) is only needed for the
rare windows that reach rendering.  ``DeviceClassifiedVariant`` therefore
carries the device results and *rehydrates* itself into the exact host
semantics on demand.
"""

from __future__ import annotations

import numpy as np

from .classify import ClassifiedVariant


class DeviceClassifiedVariant:
    """ClassifiedVariant work-alike backed by batch device outputs.

    The four classification dicts can be supplied eagerly, or deferred via
    ``builder`` (a thunk returning the 4-tuple): most context variants of a
    candidate window are never touched by the cascade, and building their
    dicts eagerly measured ~15% of the whole device scan."""

    __slots__ = ("variant", "groups", "_kwargs", "sample_counts",
                 "allele_counts", "conserved", "diagnostic", "_exact",
                 "_builder", "_missing_fn")

    def __init__(self, variant, groups, kwargs, sample_counts=None,
                 allele_counts=None, conserved=None, diagnostic=None,
                 builder=None, missing_fn=None):
        self.variant = variant
        self.groups = groups
        self._kwargs = kwargs
        self._builder = builder
        self._missing_fn = missing_fn
        if builder is None:
            self.sample_counts = sample_counts
            self.allele_counts = allele_counts
            self.conserved = conserved
            self.diagnostic = diagnostic
        self._exact = None

    def __getattr__(self, name):
        # reached only when a __slots__ attribute is still unset (lazy mode)
        if name in ("sample_counts", "allele_counts", "conserved",
                    "diagnostic"):
            builder = object.__getattribute__(self, "_builder")
            if builder is not None:
                # clear only after success: a raising builder must propagate
                # its own exception on every access, not decay to a bare
                # AttributeError that getattr/hasattr consumers would swallow
                (self.sample_counts, self.allele_counts, self.conserved,
                 self.diagnostic) = builder()
                self._builder = None
                return object.__getattribute__(self, name)
        raise AttributeError(name)

    def _rehydrate(self):
        if self._exact is None:
            self._exact = ClassifiedVariant(self.variant, self.groups,
                                            **self._kwargs)
            # adopt the exact ordered dicts so downstream rendering sees
            # reference-identical iteration order
            self.sample_counts = self._exact.sample_counts
            self.allele_counts = self._exact.allele_counts
            self.conserved = self._exact.conserved
            self.diagnostic = self._exact.diagnostic
        return self._exact

    @property
    def missing_samp_ids(self):
        if self._exact is None and self._missing_fn is not None:
            # columnar gate evaluation (set-identical to the host path,
            # tests/test_fastscan.py) — skips the O(samples) per-variant
            # dict rebuild that full rehydration pays
            return self._missing_fn()
        return self._rehydrate().missing_samp_ids

    def allele_lens(self, group):
        out = {}
        for allele in self.allele_counts[group]:
            if "/" in allele:
                out[allele] = max(len(x) for x in allele.split("/"))
            elif allele == "*":
                out[allele] = 0
            else:
                out[allele] = len(allele)
        return out

    def max_allele_len(self, group):
        if not self.allele_counts[group]:
            return len(self.variant.ref)
        return max(self.allele_lens(group).values())


def classify_stream_device(variants, groups, batch_size=4096, device="cuda",
                           **kwargs):
    """Device-batched replacement for ClassifiedVariant.from_vcf.

    Yields DeviceClassifiedVariant in input order; each batch of
    ``batch_size`` records is classified on ``device`` ("cuda", the
    default, raises without a card; "cpu" runs the same torch ops on the
    host).  Requires min_reads >= 1 (the '?' zero-coverage pseudo-allele
    is unreachable then — reference semantics, find_diag_var.py:249-251);
    callers take the host path otherwise.
    """
    import torch

    from ..device import resolve_device
    from ..ops.vcfclass import classify_batch
    from .batch import build_batch

    if kwargs.get("min_reads", 10) < 1:
        raise ValueError("device classification requires min_reads >= 1")
    dev = resolve_device(device)
    kw = dict(kwargs)
    kw.pop("force", None)
    checked = False
    batch: list = []

    def flush(batch, groups):
        arrays, group_names, _ = build_batch(batch, groups)
        arrays = {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}
        out = classify_batch(
            n_groups=len(group_names), **arrays,
            min_samples=kw.get("min_samples", 5),
            min_reads=kw.get("min_reads", 10),
            min_geno_qual=kw.get("min_geno_qual", 40),
            min_freq=kw.get("min_freq", 0.1),
            min_map_qual=kw.get("min_map_qual", 30),
            min_var_qual=kw.get("min_var_qual", 10),
            min_samp_prop=kw.get("min_samp_prop", 0.9))
        sc, ac, consv, diag = (
            out[k].cpu().numpy() for k in ("sample_counts", "allele_counts",
                                           "conserved", "diagnostic"))
        for vi, var in enumerate(batch):
            alleles = var.alleles
            sample_counts = {g: int(sc[vi, gi])
                            for gi, g in enumerate(group_names)}
            allele_counts = {
                g: {alleles[ai]: int(c)
                    for ai, c in enumerate(ac[vi, gi]) if c > 0}
                for gi, g in enumerate(group_names)}
            conserved = {g: (None if consv[vi, gi] < 0
                             else alleles[consv[vi, gi]])
                         for gi, g in enumerate(group_names)}
            diagnostic = {g: (None if diag[vi, gi] < 0
                              else alleles[diag[vi, gi]])
                          for gi, g in enumerate(group_names)}
            yield DeviceClassifiedVariant(var, groups, kwargs, sample_counts,
                                          allele_counts, conserved,
                                          diagnostic)

    for var in variants:
        if not checked:
            # validate group membership once (parity: find_diag_var.py:187-201)
            probe = ClassifiedVariant(var, groups, check_groups=True,
                                      **kwargs)
            groups = probe.groups
            checked = True
        batch.append(var)
        if len(batch) >= batch_size:
            yield from flush(batch, groups)
            batch = []
    if batch:
        yield from flush(batch, groups)
