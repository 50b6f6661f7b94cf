"""Framework exception hierarchy, copied from ``fugue_tpu/exceptions.py``
and trimmed to the classes the port raises. Every error raised by the
port derives from :class:`FugueTPUError`, as in the JAX package, so user
code catches one root type whichever engine it runs."""


class FugueTPUError(Exception):
    """Root of all framework errors."""


class FugueDataFrameError(FugueTPUError):
    """Errors from DataFrame construction or conversion."""


class FugueDataFrameInitError(FugueDataFrameError):
    """DataFrame could not be constructed from the given object/schema."""


class FugueDataFrameOperationError(FugueDataFrameError):
    """An operation on a DataFrame (rename/alter/head/...) is invalid."""
