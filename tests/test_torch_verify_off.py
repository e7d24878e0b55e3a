"""PyTorch/CUDA port: an unverified plan that names a column its input
lacks fails with the JAX package's error class.

With `DATAFUSION_TPU_VERIFY=0` the static verifier does not run, and a
plan that names column 9 of a 4-column table gets to lowering.  The JAX
package raises `InvalidColumnError` (a `DataFusionError`) there, with
the schema's message; so does the port, at the same step, for a
projected column, a computed projection, a predicate, an aggregate
argument and a sort key.  (`tests/test_torch_verify.py`
`test_verify_off_is_passthrough` holds that the error is not a
`PlanVerificationError`.)
"""

from __future__ import annotations

import pytest

from datafusion_tpu.exec.materialize import collect as jax_collect

import datafusion_tpu_torch as tdf

from test_torch_verify import JAX, PORT, ctx_of, lit_i, one, scan


def _plan(m, kind):
    s = scan(m)
    bad = m.Column(9)
    if kind == "projected_column":
        return m.Projection([bad], s, one(m, "x", m.DataType.INT64))
    if kind == "computed_projection":
        return m.Projection([m.BinaryExpr(bad, m.Operator.Plus, lit_i(m, 1))], s,
                            one(m, "x", m.DataType.INT64))
    if kind == "predicate":
        return m.Selection(m.BinaryExpr(bad, m.Operator.Gt, lit_i(m, 1)), s)
    if kind == "aggregate_argument":
        return m.Aggregate(s, [m.Column(0)],
                           [m.AggregateFunction("sum", [bad], m.DataType.INT64)],
                           m.Schema([m.Field("city", m.DataType.UTF8),
                                     m.Field("s", m.DataType.INT64)]))
    return m.Sort([m.SortExpr(bad, True)], s, s.schema)


@pytest.mark.parametrize("kind", ["projected_column", "computed_projection", "predicate",
                                  "aggregate_argument", "sort_key"])
def test_unverified_bad_column_raises_the_jax_error_class(tmp_path, monkeypatch, kind):
    monkeypatch.setenv("DATAFUSION_TPU_VERIFY", "0")
    errors = {}
    for m, collect in ((JAX, jax_collect), (PORT, tdf.collect)):
        with pytest.raises(m.errors.DataFusionError) as ei:
            collect(ctx_of(m, tmp_path).execute(_plan(m, kind)))
        assert not isinstance(ei.value, m.errors.PlanVerificationError)
        errors[m is PORT] = (type(ei.value).__name__, str(ei.value))
    assert errors[True] == errors[False] == (
        "InvalidColumnError", "column index 9 out of range for schema of 4 fields")
