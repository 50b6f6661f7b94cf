"""Framework exception hierarchy, copied from ``fugue_tpu/exceptions.py``
and trimmed to the classes the port raises (the workflow's and SQL's
among them). Every error raised by the
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


class FugueDatasetEmptyError(FugueDataFrameError):
    """Operation requires a non-empty frame (e.g. ``peek``)."""


FugueDataFrameEmptyError = FugueDatasetEmptyError


class FugueBug(FugueTPUError):
    """An internal invariant was violated: a framework bug, not a user error."""


class FugueWorkflowError(FugueTPUError):
    """Errors raised while building or running a workflow DAG."""


class FugueWorkflowCompileError(FugueWorkflowError):
    """Error at DAG-construction (compile) time."""


class FugueWorkflowCompileValidationError(FugueWorkflowCompileError):
    """A partition spec breaks a transformer's validation rules."""


class FugueWorkflowRuntimeError(FugueWorkflowError):
    """Error while executing the DAG."""


class FugueWorkflowRuntimeValidationError(FugueWorkflowRuntimeError):
    """An input schema breaks a transformer's validation rules."""


class FugueInterfacelessError(FugueTPUError):
    """A function can't be adapted into an extension by its annotations."""


class FugueInvalidOperation(FugueTPUError):
    """The requested operation is not allowed in the current state."""


class FugueSQLError(FugueTPUError):
    """Errors from parsing or executing SQL, and a select that breaks the
    rules of SQL (an empty or ambiguous projection, HAVING without an
    aggregate in the SELECT list)."""


class FugueSQLSyntaxError(FugueSQLError):
    """The SQL text could not be parsed."""


class FugueSQLRuntimeError(FugueSQLError):
    """The SQL executed but failed at runtime."""
