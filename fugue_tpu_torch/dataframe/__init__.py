from .dataframe import DataFrame

__all__ = ["DataFrame"]
