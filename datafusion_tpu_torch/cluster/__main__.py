"""``python -m datafusion_tpu_torch.cluster`` — run the standalone cluster
state service (replicated lease KV + membership + shared result tier).
``--standby-of host:port`` starts a log-shipping standby that promotes
itself on primary silence; ``--peers h1:p1,h2:p2`` arms the
term-exchange probe that fences a revived old primary.  See
cluster/service.py."""

import sys

from datafusion_tpu_torch.cluster.service import main

if __name__ == "__main__":
    sys.exit(main())
