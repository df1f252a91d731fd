"""Seconds a decision cycle: the window's cycles' total time over their count."""
from twinbench.readers import mean_unit_s as read  # noqa: F401
