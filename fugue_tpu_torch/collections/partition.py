"""``PartitionSpec`` and ``PartitionCursor``, copied from
``fugue_tpu/collections/partition.py``: a spec's keys (``by``), presort
(``presort``), partition count (``num``, an expression over ``ROWCOUNT``
and ``CONCURRENCY``) and repartition algorithm (``algo``: ``hash``,
``even``, ``rand`` or ``coarse``; ``"per_row"`` is ``algo="even",
num="ROWCOUNT"``), and the cursor a transformer reads its partition's keys
from. ``num`` splits a keyless host map into that many contiguous
partitions, as the JAX package's host engine does.

On one device ``algo`` moves no row: where the JAX package exchanges rows
between the shards of its mesh (``repartition``), every row is already on
the one device, so every group is whole there."""

import ast
import json
import operator
from typing import Any, Callable, Dict, List

from .._utils.assertion import assert_or_throw
from .._utils.hash import to_uuid
from .._utils.params import IndexedOrderedDict
from ..exceptions import FugueTPUError

KEYWORD_ROWCOUNT = "ROWCOUNT"
KEYWORD_CONCURRENCY = "CONCURRENCY"
_ALGOS = ("hash", "rand", "even", "coarse")
_OPS: Dict[type, Callable] = {
    ast.Add: operator.add,
    ast.Sub: operator.sub,
    ast.Mult: operator.mul,
    ast.Div: operator.truediv,
    ast.FloorDiv: operator.floordiv,
    ast.Mod: operator.mod,
    ast.Pow: operator.pow,
    ast.USub: operator.neg,
}


class PartitionSpecError(FugueTPUError):
    """Invalid partition specification."""


def parse_presort_exp(presort: Any) -> IndexedOrderedDict:
    """Parse ``"a asc, b desc"`` into an ordered ``{name: ascending}`` map.

    Accepts a ready-made dict (validated+copied) or a string expression.
    Column names may be backtick-quoted.
    """
    res = IndexedOrderedDict()
    if presort is None:
        return res
    if isinstance(presort, dict):
        for k, v in presort.items():
            assert_or_throw(
                isinstance(v, bool),
                lambda: PartitionSpecError(f"presort direction for {k} must be bool"),
            )
            res[str(k)] = v
        return res
    s = str(presort).strip()
    if s == "":
        return res
    for part in s.split(","):
        part = part.strip()
        if part == "":
            raise PartitionSpecError(f"invalid presort expression {presort!r}")
        if part.startswith("`"):
            end = part.index("`", 1)
            name = part[1:end]
            rest = part[end + 1 :].strip()
        else:
            tokens = part.split()
            name = tokens[0]
            rest = " ".join(tokens[1:])
        direction = rest.strip().lower()
        if direction in ("", "asc"):
            asc = True
        elif direction == "desc":
            asc = False
        else:
            raise PartitionSpecError(f"invalid presort direction {rest!r} in {presort!r}")
        assert_or_throw(
            name not in res,
            lambda: PartitionSpecError(f"duplicated presort key {name!r}"),
        )
        res[name] = asc
    return res


def _eval_num(expr: str, variables: Dict[str, int]) -> int:
    """A partition-number expression such as ``ROWCOUNT/4 + 1``."""

    def ev(node: ast.AST) -> Any:
        if isinstance(node, ast.Expression):
            return ev(node.body)
        if isinstance(node, ast.Constant) and isinstance(node.value, (int, float)):
            return node.value
        if isinstance(node, ast.Name) and node.id in variables:
            return variables[node.id]
        if isinstance(node, ast.BinOp) and type(node.op) in _OPS:
            return _OPS[type(node.op)](ev(node.left), ev(node.right))
        if isinstance(node, ast.UnaryOp) and type(node.op) in _OPS:
            return _OPS[type(node.op)](ev(node.operand))
        raise PartitionSpecError(f"invalid partition number expression {expr!r}")

    return int(ev(ast.parse(expr, mode="eval")))


class PartitionSpec:
    """The grouping keys of an operation, the order inside each group, and
    the number of partitions of a keyless map.

    Examples::

        PartitionSpec(by=["a"])
        PartitionSpec(by="a", presort="b desc")
        PartitionSpec({"by": ["a", "b"]})
        PartitionSpec(num="ROWCOUNT/2")
        PartitionSpec(4)                      # num=4
        PartitionSpec(spec1)                  # a copy of another spec
    """

    def __init__(self, *args: Any, **kwargs: Any):
        params: Dict[str, Any] = {}
        for a in list(args) + [kwargs]:
            if a is None:
                continue
            if isinstance(a, PartitionSpec):
                a = a.jsondict
            elif isinstance(a, str):
                if a == "per_row":
                    a = {"algo": "even", "num": KEYWORD_ROWCOUNT}
                elif a.lower() in _ALGOS + ("default",):
                    a = {"algo": a.lower()}
                else:
                    a = json.loads(a)
            elif isinstance(a, int) and not isinstance(a, bool):
                a = {"num": a}
            elif not isinstance(a, dict):
                raise PartitionSpecError(f"can't initialize PartitionSpec with {a!r}")
            for k, v in a.items():
                params[{"partition_by": "by", "num_partitions": "num"}.get(k, k)] = v
        extra = set(params) - {"by", "presort", "num", "algo"}
        assert_or_throw(
            len(extra) == 0,
            lambda: PartitionSpecError(f"invalid PartitionSpec keys {extra}"),
        )
        self._num = str(params.get("num", "0"))
        self._algo = str(params.get("algo", "")).lower()
        assert_or_throw(
            self._algo in ("", "default") + _ALGOS,
            lambda: PartitionSpecError(f"invalid algo {self._algo!r}"),
        )
        if self._algo == "default":
            self._algo = ""
        by = params.get("by") or []
        self._by: List[str] = [by] if isinstance(by, str) else [str(x) for x in by]
        assert_or_throw(
            len(set(self._by)) == len(self._by),
            lambda: PartitionSpecError(f"duplicated keys in {self._by}"),
        )
        self._presort = parse_presort_exp(params.get("presort"))
        overlap = set(self._by) & set(self._presort.keys())
        assert_or_throw(
            len(overlap) == 0,
            lambda: PartitionSpecError(f"presort keys {overlap} overlap partition keys"),
        )

    @property
    def empty(self) -> bool:
        """No keys, presort, count or algorithm: the engine decides."""
        return self._num in ("0", "") and self._algo == "" and len(self._by) == 0 and len(self._presort) == 0

    @property
    def num_partitions(self) -> str:
        return self._num

    @property
    def algo(self) -> str:
        """``hash``, ``even``, ``rand``, ``coarse``, or ``""`` (the engine's
        default: hash with keys, even without)."""
        return self._algo

    def get_num_partitions(self, **expr_map_funcs: Callable[[], int]) -> int:
        """The partition-number expression's value: ``expr_map_funcs`` maps
        each keyword (``ROWCOUNT``, ``CONCURRENCY``) to a callable, called
        only when the keyword appears."""
        expr = self._num.strip()
        if expr == "":
            return 0
        try:
            return int(expr)
        except ValueError:
            variables = {k: int(f()) for k, f in expr_map_funcs.items() if k in expr}
            return _eval_num(expr, variables)

    @property
    def partition_by(self) -> List[str]:
        return list(self._by)

    @property
    def presort(self) -> IndexedOrderedDict:
        return self._presort

    @property
    def presort_expr(self) -> str:
        return ",".join(f"{k} {'ASC' if v else 'DESC'}" for k, v in self._presort.items())

    @property
    def jsondict(self) -> Dict[str, Any]:
        return {"num": self._num, "algo": self._algo, "by": self.partition_by, "presort": self.presort_expr}

    def __uuid__(self) -> str:
        return to_uuid(self.jsondict)

    def get_sorts(self, schema: Any, with_partition_keys: bool = True) -> IndexedOrderedDict:
        """Full sort map for a physical partition: partition keys (ascending)
        + presort."""
        res = IndexedOrderedDict()
        if with_partition_keys:
            for k in self._by:
                assert_or_throw(
                    k in schema,
                    lambda: PartitionSpecError(f"partition key {k} not in {schema}"),
                )
                res[k] = True
        for k, v in self._presort.items():
            assert_or_throw(
                k in schema,
                lambda: PartitionSpecError(f"presort key {k} not in {schema}"),
            )
            res[k] = v
        return res

    def get_key_schema(self, schema: Any) -> Any:
        """The sub-schema of the partition keys."""
        return schema.extract(self._by)

    def get_cursor(self, schema: Any, physical_partition_no: int) -> "PartitionCursor":
        return PartitionCursor(schema, self, physical_partition_no)

    def __repr__(self) -> str:
        return f"PartitionSpec({json.dumps(self.jsondict)})"


class PartitionCursor:
    """The cursor over the logical partitions of one physical partition
    (``fugue_tpu/collections/partition.py`` :404): the current partition's
    number and first row, and from it the key values. The row is read only
    when asked for: most transformers never look."""

    def __init__(self, schema: Any, spec: PartitionSpec, physical_partition_no: int):
        self._schema = schema
        self._spec = spec
        self._physical_no = physical_partition_no
        self._item: Any = None
        self._item_factory: Any = None
        self._partition_no = 0
        self._slice_no = 0

    def set(self, item: Any, partition_no: int, slice_no: int) -> None:
        """``item``: the first row, or a callable that returns it."""
        self._item_factory, self._item = (item, None) if callable(item) else (None, item)
        self._partition_no = partition_no
        self._slice_no = slice_no

    @property
    def row(self) -> List[Any]:
        if self._item is None and self._item_factory is not None:
            self._item = self._item_factory()
            self._item_factory = None
        return self._item

    @property
    def partition_no(self) -> int:
        return self._partition_no

    @property
    def physical_partition_no(self) -> int:
        return self._physical_no

    @property
    def slice_no(self) -> int:
        return self._slice_no

    @property
    def row_schema(self) -> Any:
        return self._schema

    @property
    def key_schema(self) -> Any:
        return self._schema.extract(self._spec.partition_by)

    @property
    def _key_index(self) -> List[int]:
        # found when read: a cotransformer's ``on_init`` cursor has no row
        # schema, only the spec
        return [self._schema.index_of_key(k) for k in self._spec.partition_by]

    @property
    def key_value_array(self) -> List[Any]:
        return [self.row[i] for i in self._key_index]

    @property
    def key_value_dict(self) -> Dict[str, Any]:
        return {self._schema.names[i]: self.row[i] for i in self._key_index}
