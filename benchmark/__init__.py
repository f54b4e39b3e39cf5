"""The benchmark of krisp_tpu_torch: one cell of BENCHMARK.json at a time.

``python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once and prints one JSON line (see
README.md).  Nothing here imports JAX or the JAX package ``krisp_tpu``.
"""
