"""Milliseconds a drain iteration the host waits for the card: the
program's ``drain.read`` spans over ``drain.steps``."""
from twinbench.cycle_spans import wait_ms as read  # noqa: F401
