"""Milliseconds a decision spends outside its drain loop: the program's
``decision`` span less its ``drain`` span (the fan's draw, broadcast,
metrics, CVaR, selection, the run-mask read)."""
from twinbench.cycle_spans import prep_ms as read  # noqa: F401
