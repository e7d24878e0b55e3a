"""`python -m datafusion_tpu_torch.worker`: the worker-node entry point
(the JAX package's `worker.py`).  See parallel/worker.py."""

import sys

from datafusion_tpu_torch.parallel.worker import main

if __name__ == "__main__":
    sys.exit(main())
