"""Ensemble members rounded in the window, over the window's seconds."""

from portbench.metrics import rate as read  # noqa: F401
