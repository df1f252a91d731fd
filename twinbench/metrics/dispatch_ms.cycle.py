"""Milliseconds a drain iteration the host spends dispatching: the
program's ``drain`` spans less their ``drain.read`` children, over
``drain.steps``."""
from twinbench.cycle_spans import dispatch_ms as read  # noqa: F401
