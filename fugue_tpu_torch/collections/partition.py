"""``PartitionSpec``, copied from ``fugue_tpu/collections/partition.py``
and trimmed to its keys (``by``) and its presort (``presort``): the parts
of a spec that the ported ``aggregate`` and ``transform`` read. The other
fields of the JAX package's spec (``algo``, ``num``) steer repartitioning,
which the port does not have yet; asking for them raises
``NotImplementedError``.

On one device the port needs no exchange: where the JAX package's keyed map
asks for ``algo="hash"`` to bring every group onto one shard, every group
is already whole on the one device, and the port skips it."""

from typing import Any, Dict, List

from .._utils.assertion import assert_or_throw
from .._utils.params import IndexedOrderedDict
from ..exceptions import FugueTPUError


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


class PartitionSpec:
    """The grouping keys of an operation and the order inside each group.

    Examples::

        PartitionSpec(by=["a"])
        PartitionSpec(by="a", presort="b desc")
        PartitionSpec({"by": ["a", "b"]})
        PartitionSpec(spec1)                  # a copy of another spec
    """

    def __init__(self, *args: Any, **kwargs: Any):
        params: Dict[str, Any] = {}
        for a in args:
            if a is None:
                continue
            if isinstance(a, PartitionSpec):
                params.update(a.jsondict)
            elif isinstance(a, dict):
                params.update(a)
            else:
                raise PartitionSpecError(f"can't initialize PartitionSpec with {a!r}")
        params.update(kwargs)
        extra = sorted(k for k in params if k not in ("by", "presort"))
        if len(extra) > 0:
            raise NotImplementedError(
                f"PartitionSpec fields {extra} are not ported yet; the port "
                "reads only `by` and `presort` (ROADMAP.md A.7 repartition)"
            )
        by = params.get("by", [])
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
        return {"by": self.partition_by, "presort": self.presort_expr}

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

    def __repr__(self) -> str:
        return f"PartitionSpec(by={self._by!r}, presort={self.presort_expr!r})"
