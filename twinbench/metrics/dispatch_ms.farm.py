"""Milliseconds a replay step the host spends dispatching: the program's
``replay`` spans less their ``replay.read`` children, over ``replay.steps``."""
from twinbench.spans import dispatch_ms as read  # noqa: F401
