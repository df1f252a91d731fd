"""Per cent of the replay steps dispatched that had work left: the
program's ``replay.iters`` over ``replay.steps``."""
from twinbench.spans import useful_steps as read  # noqa: F401
