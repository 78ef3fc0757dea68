"""``frames_per_s``: see ``portbench/readers.py``."""

from portbench.readers import frames_per_s as read  # noqa: F401
