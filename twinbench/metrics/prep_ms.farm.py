"""Milliseconds a grid spends outside its replay loop: the program's
``grid`` span less its ``replay`` span (uploads, hoisting, selection)."""
from twinbench.spans import prep_ms as read  # noqa: F401
