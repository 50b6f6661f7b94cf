"""Deterministic uuid hashing, copied from ``fugue_tpu/_utils/hash.py``.

Only stable representations are hashed (no ``id()``, no ``hash()``), so a
uuid is the same across processes and runs.
"""

import uuid
from hashlib import md5
from typing import Any


def _feed(h: Any, obj: Any) -> None:
    if obj is None:
        h.update(b"\x00N")
    elif isinstance(obj, bool):
        h.update(b"\x00B" + (b"1" if obj else b"0"))
    elif isinstance(obj, int):
        h.update(b"\x00I" + str(obj).encode())
    elif isinstance(obj, float):
        h.update(b"\x00F" + repr(obj).encode())
    elif isinstance(obj, str):
        h.update(b"\x00S" + obj.encode())
    elif isinstance(obj, bytes):
        h.update(b"\x00Y" + obj)
    elif hasattr(obj, "__uuid__"):
        h.update(b"\x00U" + obj.__uuid__().encode())
    elif isinstance(obj, dict):
        h.update(b"\x00D")
        for k, v in obj.items():
            _feed(h, k)
            _feed(h, v)
        h.update(b"\x00d")
    elif isinstance(obj, (list, tuple)) or hasattr(obj, "__iter__"):
        h.update(b"\x00L")
        for x in obj:
            _feed(h, x)
        h.update(b"\x00l")
    else:
        h.update(b"\x00O" + repr(obj).encode())


def to_uuid(*args: Any) -> str:
    h = md5()
    for a in args:
        _feed(h, a)
    return str(uuid.UUID(bytes=h.digest()))
