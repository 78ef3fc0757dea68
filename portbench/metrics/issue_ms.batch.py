"""``issue_ms.batch``: host ms to issue one call, over every call of the
window."""

from portbench.readers import issue_ms as read  # noqa: F401
