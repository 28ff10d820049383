"""Each test process runs torch on its share of the host's cores.

pytest-xdist starts one process a worker, and torch gives each process
an intra-op thread a core, so six workers on eight cores ran 48 threads
that took turns on the cores.  Each process here takes the cores over
the workers (`PYTEST_XDIST_WORKER_COUNT`, which xdist sets in each
worker; 1 without it).  Only torch's own count is set: an environment
variable such as OMP_NUM_THREADS would cap numpy's BLAS as well, and
the JAX package's tests configure JAX in `tests/conftest.py`.
"""

import os

import torch

torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT",
                                                "1"))))
