from .partition import PartitionCursor, PartitionSpec, PartitionSpecError, parse_presort_exp

__all__ = ["PartitionCursor", "PartitionSpec", "PartitionSpecError", "parse_presort_exp"]
