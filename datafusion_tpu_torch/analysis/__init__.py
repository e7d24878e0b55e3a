"""Static verification and lock checking, the counterpart of the JAX
package's `analysis/`.  Three analyzers, each usable on its own:

- `analysis.verify`: the plan-IR verifier (schemas bottom-up; runs in
  `ExecutionContext` under `DATAFUSION_TPU_VERIFY`, and as `EXPLAIN
  VERIFY <sql>`).
- `analysis.lint`: the invariant linter, rules DF001 to DF008 (host
  syncs in `exec/`, wall clock in replayable code, IO boundaries behind
  fault sites, broad excepts, locks in metrics callbacks, raw
  host-to-device copies, blocking IO in the sampler, disk IO under a
  lock).  CLI: ``python -m datafusion_tpu_torch.analysis [paths]
  [--format=github] [--list-rules] [--lockcheck-report FILE]``.
- `analysis.lockcheck`: the lock-order checker behind `make_lock`
  (``DATAFUSION_TPU_LOCKCHECK=1``), which every named lock of the port
  goes through.
"""

# No eager submodule imports: `analysis.lockcheck` sits on the coldest
# import path (utils/metrics, the fault plan, the cache) and must not
# drag the verifier or the linter in.  Import the submodules directly:
#   from datafusion_tpu_torch.analysis import lint, lockcheck, verify
