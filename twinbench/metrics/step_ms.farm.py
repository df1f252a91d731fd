"""Milliseconds a replay iteration: grid time over K1 launches."""
from twinbench.readers import step_ms as read  # noqa: F401
