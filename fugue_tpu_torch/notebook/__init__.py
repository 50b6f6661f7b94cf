"""The ``%%fsql`` cell magic and the HTML display (``env.py``)."""

from .env import NotebookSetup, _load_ipython_extension, setup

__all__ = ["NotebookSetup", "setup"]


def load_ipython_extension(ip):  # pragma: no cover - ipython hook
    _load_ipython_extension(ip)
