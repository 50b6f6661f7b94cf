"""The port's dialect transpiler (``fugue_tpu_torch/sql/dialect.py``)
against the JAX package's (``fugue_tpu/sql/dialect.py``).

- each case of ``tests/core/test_dialect.py`` runs as written with its
  names bound to the port's modules (the golden strings are the
  reference's own);
- a differential: every query of a corpus, between every pair of
  registered dialects, gives the same string through both modules
  (exact), or the same syntax error;
- FugueSQL under a foreign ``fugue.sql.compile.dialect`` on the port's
  native and torch engines answers as the reference does (rows exact).
"""

import itertools
import types

import numpy as np
import pandas as pd
import pytest

import tests.core.test_dialect as ref_cases
from fugue_tpu.sql import dialect as jdialect
from fugue_tpu.sql import FugueSQLWorkflow as JFugueSQLWorkflow
from fugue_tpu.execution import NativeExecutionEngine as JNativeExecutionEngine
from fugue_tpu.jax import JaxExecutionEngine
from fugue_tpu_torch.collections.sql import StructuredRawSQL, transpile_sql
from fugue_tpu_torch.exceptions import FugueSQLSyntaxError
from fugue_tpu_torch.execution import NativeExecutionEngine
from fugue_tpu_torch.sql import DialectProfile, register_dialect, transpile
from fugue_tpu_torch.sql import dialect as tdialect
from fugue_tpu_torch.sql.fsql import FugueSQLWorkflow
from fugue_tpu_torch.torch import TorchExecutionEngine
from torch_tuned_store import own_tuned_store  # noqa: F401  (a tuned store of each test's own)

REF_CONF = {"fugue.tpu.cache.enabled": False}

# the reference's cases that exercise the transpiler alone (its FugueSQL
# case runs the reference's global conf and api; it has its own port below)
_CASES = [
    "test_quoting_conversions",
    "test_cast_type_mapping",
    "test_function_renames_round_trip",
    "test_limit_top_conversion",
    "test_bool_literals",
    "test_same_dialect_is_identity",
    "test_unknown_dialect_raises",
    "test_custom_dialect_registration",
    "test_structured_raw_sql_routes_through_plugin",
    "test_round_trip_preserves_token_stream",
]


def _ported(name: str) -> types.FunctionType:
    """The reference's case with its module's names bound to the port's."""
    f = getattr(ref_cases, name)
    g = dict(f.__globals__)
    g.update(
        StructuredRawSQL=StructuredRawSQL,
        transpile_sql=transpile_sql,
        FugueSQLSyntaxError=FugueSQLSyntaxError,
        DialectProfile=DialectProfile,
        register_dialect=register_dialect,
        transpile=transpile,
    )
    return types.FunctionType(f.__code__, g, f.__name__, f.__defaults__, f.__closure__)


@pytest.mark.parametrize("name", _CASES)
def test_reference_case_on_the_port(name, monkeypatch):
    # the round-trip case imports the module by its path: point it at the port's
    import sys

    monkeypatch.setitem(sys.modules, "fugue_tpu.sql.dialect", tdialect)
    _ported(name)()


_CORPUS = [
    'SELECT `a b`, "s" FROM t WHERE x = \'it\'\'s\' LIMIT 7',
    "SELECT CAST(x AS double), CAST(y AS long), CAST(z AS bool) FROM t",
    "SELECT SUBSTRING(s, 1, 2), STRING_AGG(s), NVL(a, 0), CEILING(b) FROM t GROUP BY k",
    "SELECT TOP 3 a FROM t ORDER BY a",
    "SELECT * FROM t WHERE ok = TRUE AND bad = FALSE OR x <> 1.5e3",
    "SELECT * FROM (SELECT a FROM t LIMIT 5) q",
    'SELECT "a b", [c d] FROM `my tbl` INNER JOIN u ON t.k = u.k',
    "SELECT k << 2, a & 7, b || 'x' FROM t",
]


@pytest.mark.parametrize("src,dst", list(itertools.permutations(
    ["fugue", "spark", "sqlite", "postgres", "mysql", "mssql"], 2)))
def test_transpile_matches_the_reference(src, dst):
    """The same string, or the same syntax error, from both modules."""
    for q in _CORPUS:
        try:
            exp = jdialect.transpile(q, src, dst)
        except Exception as e:  # noqa: BLE001 - the port must raise alike
            with pytest.raises(FugueSQLSyntaxError, match=str(e).split(" at ")[0]):
                tdialect.transpile(q, src, dst)
            continue
        assert tdialect.transpile(q, src, dst) == exp, (src, dst, q)


@pytest.mark.parametrize("dialect,q", [
    ("postgres", 'SELECT k, SUM(CAST(v AS DOUBLE PRECISION)) AS s FROM df WHERE ok = TRUE GROUP BY k '
                 "YIELD DATAFRAME AS r"),
    ("mssql", "SELECT TOP 2 k, v FROM df ORDER BY v YIELD DATAFRAME AS r"),
])
@pytest.mark.parametrize("engine", ["native", "torch"])
def test_fugue_sql_foreign_compile_dialect(dialect, q, engine):
    """``tests/core/test_dialect.py::test_fugue_sql_foreign_compile_dialect``
    through both packages, each workflow with the compile dialect in its
    conf."""
    df = pd.DataFrame({"k": np.array([1, 2, 2]), "v": [1.0, 2.0, 3.0], "ok": [True, True, False]})
    dag = FugueSQLWorkflow({"fugue.sql.compile.dialect": dialect})
    dag(q, df=df)
    dag.run(NativeExecutionEngine() if engine == "native" else TorchExecutionEngine(device="cpu"))
    jdag = JFugueSQLWorkflow({"fugue.sql.compile.dialect": dialect, **REF_CONF})
    jdag(q, df=df)
    jdag.run(JNativeExecutionEngine(REF_CONF) if engine == "native" else JaxExecutionEngine(REF_CONF))
    got = dag.yields["r"].result.as_pandas()
    exp = jdag.yields["r"].result.as_pandas()
    key = list(got.columns)
    got = got.sort_values(key).reset_index(drop=True)
    exp = exp.sort_values(key).reset_index(drop=True)
    assert list(got.columns) == list(exp.columns) and len(got) > 0
    assert got.astype(object).values.tolist() == exp.astype(object).values.tolist()
