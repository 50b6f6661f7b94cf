"""``# schema:`` comments, copied from ``fugue_tpu/extensions/_shared.py``
(``comment_block_above``, ``parse_comment_annotation``) and trimmed to
them: the string registry of extension names is not ported (ROADMAP.md
A.11)."""

import inspect
import re
from typing import Callable, List, Optional


def comment_block_above(func: Callable) -> List[str]:
    """The contiguous comment lines directly above a function's ``def``
    (decorators skipped), without their ``#``."""
    try:
        lines, start = inspect.findsource(func)
    except (OSError, TypeError):
        return []
    i = start - 1
    while i >= 0 and lines[i].strip().startswith("@"):
        i -= 1
    block: List[str] = []
    while i >= 0:
        stripped = lines[i].strip()
        if stripped.startswith("#"):
            block.insert(0, stripped[1:].strip())
        elif stripped != "":
            break
        i -= 1
    return block


def parse_comment_annotation(func: Callable, annotation: str = "schema") -> Optional[str]:
    """The value of ``# schema: ...`` (or another annotation) directly above
    a function; the last one wins."""
    pattern = re.compile(r"^" + annotation + r"\s*:(.*)$")
    result: Optional[str] = None
    for line in comment_block_above(func):
        m = pattern.match(line)
        if m is not None:
            result = m.group(1).strip()
    return result
