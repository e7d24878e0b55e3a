"""CLI: ``python -m datafusion_tpu_torch.analysis [paths...]``.

Runs the invariant linter over the given paths (default:
``datafusion_tpu_torch/``) and exits nonzero on findings.
``--format=github`` prints workflow-annotation lines.
``--lockcheck-report FILE`` instead evaluates a lock-order report that
a ``DATAFUSION_TPU_LOCKCHECK=1`` run wrote (`analysis/lockcheck.py`'s
exit hook) and exits nonzero when it recorded cycles or blocking calls
under a held lock; the JAX package's exit codes and lines.
"""

from __future__ import annotations

import argparse
import json
import sys

from datafusion_tpu_torch.analysis.lint import RULES, lint_paths

DEFAULT_PATH = "datafusion_tpu_torch"


def _check_lockcheck_report(path: str) -> int:
    with open(path, "r", encoding="utf-8") as f:
        report = json.load(f)
    cycles = report.get("cycles") or []
    blocking = report.get("blocking") or []
    for cyc in cycles:
        print(f"lockcheck: lock-order cycle: {' -> '.join(cyc['cycle'])}")
        for edge in cyc.get("edges", []):
            print(f"  edge {edge['held']} -> {edge['acquired']} "
                  f"({edge.get('site', '?')})")
    for b in blocking:
        print(f"lockcheck: blocking call {b['op']!r} while holding "
              f"{b['held']} ({b.get('site', '?')})")
    n = len(cycles) + len(blocking)
    print(f"lockcheck report: {n} issue(s), "
          f"{len(report.get('edges') or [])} lock-order edge(s) observed")
    return 1 if n else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m datafusion_tpu_torch.analysis",
        description="datafusion-tpu port invariant linter "
                    "(project rules DF001-DF008)",
    )
    ap.add_argument("paths", nargs="*", default=[DEFAULT_PATH],
                    help=f"files/directories to lint (default: {DEFAULT_PATH})")
    ap.add_argument("--format", choices=("text", "github"), default="text",
                    help="finding output format (github = workflow "
                         "annotations)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    ap.add_argument("--lockcheck-report", metavar="FILE", default=None,
                    help="evaluate a DATAFUSION_TPU_LOCKCHECK report "
                         "file instead of linting")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule in RULES:
            doc = (rule.__doc__ or "").strip().splitlines()[0]
            print(f"{rule.id}  {doc}")
        return 0
    if args.lockcheck_report is not None:
        return _check_lockcheck_report(args.lockcheck_report)

    paths = args.paths or [DEFAULT_PATH]
    findings = lint_paths(paths)
    for f in findings:
        print(f.github() if args.format == "github" else f.text())
    print(f"{len(findings)} finding(s) in {', '.join(paths)}")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
