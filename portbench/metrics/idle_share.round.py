"""The share of the traced window in which the device ran no kernel and no
copy, from the union of the device's intervals."""

from portbench.metrics import idle_share_pct as read  # noqa: F401
