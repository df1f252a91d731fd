"""Drain iterations a cycle: K1 launches over the window's cycles."""
from twinbench.readers import k1_per_unit as read  # noqa: F401
