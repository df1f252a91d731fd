"""Forks a second: all forks of the window's grids over their total time."""
from twinbench.readers import forks_per_s as read  # noqa: F401
