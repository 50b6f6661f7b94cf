"""The dataset base and functions of the port (``fugue_tpu/dataset/``):
``Dataset`` is the base of the port's bags; its frames keep their own
base and share the display chain (``dataset.py``)."""

from .dataset import Dataset, DatasetDisplay, get_dataset_display, register_dataset_display

__all__ = ["Dataset", "DatasetDisplay", "get_dataset_display", "register_dataset_display"]
