"""One process of the port's process-group routing test (spawned by
``tests/test_torch_budget.py``): brings up a gloo process group over the
CPU (``parallel.multihost.init_runtime``), builds the mesh over it
(``pod_mesh``), gives this process's device the budget named on the
command line and runs ``run_pipeline`` over the mesh on the genomes named
there (the first two the ingroup).  Prints the route it took and its
groups.  Imports no JAX.  argv: port rank world_size budget genome...
"""

import os
import sys

# run as a script: sys.path[0] is tests/, so make the repository root
# importable
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from datetime import timedelta  # noqa: E402

import torch.distributed as dist  # noqa: E402

from krisp_tpu_torch.engine import pipeline as P  # noqa: E402
from krisp_tpu_torch.metrics import GLOBAL as METRICS  # noqa: E402
from krisp_tpu_torch.parallel.multihost import (  # noqa: E402
    init_runtime, pod_mesh)

port, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
budget, paths = int(sys.argv[4]), sys.argv[5:]
assert init_runtime(f"tcp://localhost:{port}", world, rank, device="cpu",
                    timeout=timedelta(seconds=60))
mesh = pod_mesh("cpu")
P.device_budget = lambda dev: budget
METRICS.reset()
groups = P.run_pipeline(paths[:2], paths[2:], P.KmerGeometry(25, 1, 2),
                        ingroup_filter=False, device="cpu", mesh=mesh)
route = "staged" if "intersect" in METRICS.stages else "fused"
print(f"ROUTE {rank} {route}")
print("GROUPS " + repr([(g.left, g.right, [(a.mid, a.label_counts)
                                           for a in g.amplicons])
                        for g in groups]))
dist.barrier()
dist.destroy_process_group()
