"""Synthetic inputs for the port's VCF tests, importable without JAX (the
card's machine runs ``tests/test_torch_kernels_cuda.py`` with no JAX)."""

import gzip

import numpy as np

from test_vcf_fuzz import GROUPS, SAMPLES


def synth_fuzz_diag_inputs(tmp_path, seed, contigs=("ctg1", "ctg2"),
                           contig_len=9000):
    """``synth_fuzz_inputs``' recipe (indels, multiallelics, missing calls,
    failing DP gates, low QUAL and MQ) over several contigs, except that at
    EU1's fixed-ALT sites the other group calls REF: in the fuzz recipe it
    calls het there, so no window can be diagnostic."""
    rng = np.random.default_rng(seed)
    meta = tmp_path / "meta.csv"
    meta.write_text("sample_id,group\n" + "".join(
        f"{s},{g}\n" for g, ss in GROUPS.items() for s in ss))
    seqs = {c: "".join(rng.choice(list("ACGT"), size=contig_len))
            for c in contigs}
    with open(tmp_path / "ref.fasta", "w") as fh:
        for c, seq in seqs.items():
            fh.write(f">{c}\n")
            for i in range(0, contig_len, 70):
                fh.write(seq[i:i + 70] + "\n")
    records = []
    for c, seq in seqs.items():
        pos = 60
        while pos < contig_len - 200:
            ref_len = int(rng.choice([1, 1, 1, 2, 3]))
            ref_allele = seq[pos - 1:pos - 1 + ref_len]
            n_alts = int(rng.choice([1, 1, 1, 2]))
            alts = []
            while len(alts) < n_alts:
                alt_len = int(rng.choice([1, 1, ref_len, ref_len + 1,
                                          max(1, ref_len - 1)]))
                a = "".join(rng.choice(list("ACGT"), size=alt_len))
                if a != ref_allele and a not in alts:
                    alts.append(a)
            qual = int(rng.choice([900, 900, 900, 5]))
            mq = int(rng.choice([60, 60, 60, 10]))
            scenario = rng.random()
            cols = []
            for g, ss in GROUPS.items():
                for _ in ss:
                    r = rng.random()
                    if r < 0.08:
                        cols.append("./.:.:.:.")
                    elif r < 0.14:
                        cols.append("0/0:" + ",".join(["4"] + ["0"] * n_alts)
                                    + ":4:99")
                    elif scenario < 0.35 and g == "EU1":
                        ad = ["0"] * (1 + n_alts)
                        ad[1] = "48"
                        cols.append(f"1/1:{','.join(ad)}:48:99")
                    elif 0.35 <= scenario < 0.45:
                        ad = ["25", "25"] + ["0"] * (n_alts - 1)
                        cols.append(f"0/1:{','.join(ad)}:50:99")
                    else:
                        cols.append("0/0:" + ",".join(["50"] + ["0"] * n_alts)
                                    + ":50:99")
            records.append((c, pos, ref_allele, ",".join(alts), qual, mq,
                            cols))
            pos += int(rng.integers(25, 90))
    vcf = tmp_path / "vars.vcf.gz"
    with gzip.open(vcf, "wt") as fh:
        fh.write("##fileformat=VCFv4.2\n")
        fh.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                 + "\t".join(SAMPLES) + "\n")
        for chrom, p, ref, alt, qual, mq, cols in records:
            fh.write(f"{chrom}\t{p}\t.\t{ref}\t{alt}\t{qual}\tPASS\tMQ={mq}\t"
                     "GT:AD:DP:GQ\t" + "\t".join(cols) + "\n")
    return str(meta), str(tmp_path / "ref.fasta"), str(vcf)


def cohort_batch(seed, V, S, A, G):
    """``classify_batch``'s arrays for V records x S samples x A alleles in
    G equal groups, in ``tools/bench_vcf_scaled.py``'s mix: most records
    REF in every group, some with one group fixed for an ALT (diagnostic
    candidates), some with mixed or het calls, failing gates, missing
    calls or low qualities."""
    rng = np.random.default_rng(seed)
    group_id = (np.arange(S) * G // S).astype(np.int32)
    n_alleles = rng.integers(2, A + 1, V).astype(np.int32)
    kind = rng.random(V)
    fixed = np.zeros((V, G), np.int64)
    diag = kind < 0.2
    fixed[diag, rng.integers(0, G, diag.sum())] = rng.integers(
        1, n_alleles[diag])
    allele = fixed[:, group_id]
    noisy = (kind >= 0.2) & (kind < 0.3)
    mixed = noisy[:, None] & (rng.random((V, S)) < 0.3)
    allele = np.where(mixed, rng.integers(0, n_alleles[:, None], (V, S)),
                      allele)
    depth = rng.integers(12, 60, (V, S)).astype(np.int32)
    ad = np.zeros((V, S, A), np.int32)
    np.put_along_axis(ad, allele[:, :, None], depth[:, :, None], axis=2)
    het = noisy[:, None] & (rng.random((V, S)) < 0.2)
    ad[het, 0] += depth[het] // 2
    dp = ad.sum(axis=2, dtype=np.int32)
    gq = rng.integers(45, 99, (V, S)).astype(np.int32)
    low = ((kind >= 0.3) & (kind < 0.35))[:, None] & (rng.random((V, S))
                                                      < 0.5)
    dp[low] = 4
    miss = ((kind >= 0.35) & (kind < 0.38))[:, None] | (rng.random((V, S))
                                                        < 0.001)
    dp[miss] = -1
    gq[miss] = -1
    ad[miss] = 0
    mq = np.where(rng.random(V) < 0.03, 10, 60).astype(np.float32)
    qual = np.where(rng.random(V) < 0.03, 5, 900).astype(np.float32)
    return dict(dp=dp, gq=gq, ad=ad, n_alleles=n_alleles, mq=mq, qual=qual,
                group_id=group_id,
                group_sizes=np.bincount(group_id, minlength=G)
                .astype(np.int32))
