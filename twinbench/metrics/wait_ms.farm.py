"""Milliseconds a replay step the host waits for the card: the program's
``replay.read`` spans over ``replay.steps``."""
from twinbench.spans import wait_ms as read  # noqa: F401
