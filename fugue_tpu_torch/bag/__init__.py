from .bag import Bag, BagDisplay, LocalBag, LocalBoundedBag
from .array_bag import ArrayBag

__all__ = ["Bag", "BagDisplay", "LocalBag", "LocalBoundedBag", "ArrayBag"]
