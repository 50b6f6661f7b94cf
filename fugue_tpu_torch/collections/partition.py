"""``PartitionSpec``, copied from ``fugue_tpu/collections/partition.py``
and trimmed to its keys (``by``): the only part of a spec that the ported
``aggregate`` reads. The other fields of the JAX package's spec (``algo``,
``num``, ``presort``) steer repartitioning and presorted maps, which the
port does not have yet; asking for them raises ``NotImplementedError``."""

from typing import Any, Dict, List

from .._utils.assertion import assert_or_throw
from ..exceptions import FugueTPUError


class PartitionSpecError(FugueTPUError):
    """Invalid partition specification."""


class PartitionSpec:
    """The grouping keys of an operation.

    Examples::

        PartitionSpec(by=["a"])
        PartitionSpec(by="a")
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
        extra = sorted(k for k in params if k != "by")
        if len(extra) > 0:
            raise NotImplementedError(
                f"PartitionSpec fields {extra} are not ported yet; the port "
                "reads only `by` (ROADMAP.md A.7 repartition)"
            )
        by = params.get("by", [])
        self._by: List[str] = [by] if isinstance(by, str) else [str(x) for x in by]
        assert_or_throw(
            len(set(self._by)) == len(self._by),
            lambda: PartitionSpecError(f"duplicated keys in {self._by}"),
        )

    @property
    def partition_by(self) -> List[str]:
        return list(self._by)

    @property
    def jsondict(self) -> Dict[str, Any]:
        return {"by": self.partition_by}

    def __repr__(self) -> str:
        return f"PartitionSpec(by={self._by!r})"
