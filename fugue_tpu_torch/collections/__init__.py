from .partition import PartitionSpec, PartitionSpecError, parse_presort_exp

__all__ = ["PartitionSpec", "PartitionSpecError", "parse_presort_exp"]
