from .partition import PartitionSpec, PartitionSpecError

__all__ = ["PartitionSpec", "PartitionSpecError"]
