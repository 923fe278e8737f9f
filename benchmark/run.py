"""The benchmark of mulls_tpu_torch's fleet odometry: one cell, one seed,
one run.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout on a machine with the card(s) the cell asks
for.  The cells, their configurations, traffic mixes and metrics are named
in ``BENCHMARK.json`` at the root and found by name under this folder
(``benchlib/catalog.py``).  The last line of standard output is the run's
result as one JSON object.

The process runs with one CPU thread per pool (OpenMP, MKL, OpenBLAS and
torch's intra-op pool): the host dispatches the step, and a pool's
spinning threads on shared cores would only add noise to the host's time.
"""

import os
import sys
import time

T0 = time.perf_counter()
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, ROOT]

from benchlib.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], ROOT, T0))
