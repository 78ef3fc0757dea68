"""``kernel_roofline.batch``: frames x the least time a frame takes on
the card (bytes or operations, whichever bounds it) over the union of the
window's kernel intervals."""

from portbench.readers import kernel_roofline_pct as read  # noqa: F401
