"""Device operators of the krisp_fasta engine (counterparts of
``krisp_tpu.ops``)."""
