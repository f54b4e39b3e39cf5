"""FASTA input (copy of ``krisp_tpu.io``'s ``fasta`` and ``native``)."""
