"""``setup_s``: see ``portbench/readers.py``."""

from portbench.readers import setup_s as read  # noqa: F401
