from .plugins import (
    FugueTestBackend,
    fugue_test_backend,
    fugue_test_suite,
    get_test_backend,
    with_backend,
)
