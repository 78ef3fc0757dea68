"""``device_idle_pct.batch``: share of the traced window with no kernel,
copy or set on the card."""

from portbench.readers import device_idle_pct as read  # noqa: F401
