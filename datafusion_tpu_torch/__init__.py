"""datafusion-tpu on PyTorch and CUDA: the port of the JAX package
`datafusion_tpu` to one NVIDIA H100.

The module layout and names follow the JAX package, so each module's
counterpart is found at the same path.  This package imports torch and
numpy, never jax, and nothing of `datafusion_tpu`.  Plain tensor work
is PyTorch; each Pallas kernel of the JAX package becomes a CUDA C++
kernel for Hopper under `csrc/`, built on first use
(`exec/cuda/__init__.py`).

Entry points run on `cuda:0` unless the caller asks for the CPU:

    ctx = ExecutionContext()            # cuda:0, or ExecutionError
    ctx = ExecutionContext(device="cpu")
    ctx.register_datasource("t", MemoryDataSource(schema, batches))
    ctx.register_csv("cities", "test/data/uk_cities.csv", schema, has_header=False)
    table = collect(ctx.sql("SELECT k, SUM(v) FROM t GROUP BY k"))
    ctx.sql("CREATE EXTERNAL TABLE p (id INT) STORED AS CSV WITH HEADER ROW "
            "LOCATION 'test/data/people.csv'")       # -> DdlResult
    ctx.sql_collect("EXPLAIN VERIFY SELECT id FROM p")  # -> ExplainVerifyResult
    print(ctx.sql("EXPLAIN ANALYZE SELECT id FROM p"))  # -> ExplainAnalyzeResult
    df = ctx.table("t").filter(...).aggregate([...], [f.sum(...)])

The console: `python -m datafusion_tpu_torch.cli [--script FILE]
[--device cpu]`.
"""

from datafusion_tpu_torch.errors import (
    DataFusionError,
    ExecutionError,
    InvalidColumnError,
    IoError,
    NotSupportedError,
    ParserError,
    PlanError,
)
from datafusion_tpu_torch.datatypes import (
    DataType,
    Field,
    Schema,
    StructType,
    can_coerce_from,
    get_supertype,
)
from datafusion_tpu_torch.plan.expr import (
    AggregateFunction,
    BinaryExpr,
    Cast,
    Column,
    Expr,
    FunctionMeta,
    FunctionType,
    IsNotNull,
    IsNull,
    Literal,
    Operator,
    ScalarFunction,
    ScalarValue,
    SortExpr,
)
from datafusion_tpu_torch.plan.logical import (
    Aggregate,
    EmptyRelation,
    Limit,
    LogicalPlan,
    Projection,
    Selection,
    Sort,
    TableScan,
)
from datafusion_tpu_torch.exec.batch import StringDictionary, make_host_batch
from datafusion_tpu_torch.exec.context import DdlResult, ExecutionContext, ExplainResult
from datafusion_tpu_torch.exec.datasource import (
    CsvDataSource,
    MemoryDataSource,
    NdJsonDataSource,
    ParquetDataSource,
)
from datafusion_tpu_torch.exec.materialize import ResultTable, collect
from datafusion_tpu_torch.analysis.verify import ExplainVerifyResult
from datafusion_tpu_torch.obs.explain import ExplainAnalyzeResult
from datafusion_tpu_torch.dataframe import DataFrame, f, lit

__version__ = "0.1.0"

__all__ = [
    "DataFusionError",
    "ExecutionError",
    "InvalidColumnError",
    "IoError",
    "NotSupportedError",
    "ParserError",
    "PlanError",
    "DataType",
    "Field",
    "Schema",
    "StructType",
    "can_coerce_from",
    "get_supertype",
    "Expr",
    "Column",
    "Literal",
    "BinaryExpr",
    "IsNull",
    "IsNotNull",
    "Cast",
    "SortExpr",
    "ScalarFunction",
    "AggregateFunction",
    "ScalarValue",
    "Operator",
    "FunctionMeta",
    "FunctionType",
    "LogicalPlan",
    "Projection",
    "Selection",
    "Aggregate",
    "Sort",
    "Limit",
    "TableScan",
    "EmptyRelation",
    "ExecutionContext",
    "DdlResult",
    "ExplainResult",
    "ExplainVerifyResult",
    "ExplainAnalyzeResult",
    "DataFrame",
    "f",
    "lit",
    "MemoryDataSource",
    "CsvDataSource",
    "NdJsonDataSource",
    "ParquetDataSource",
    "ResultTable",
    "StringDictionary",
    "collect",
    "make_host_batch",
    "__version__",
]
