"""Per cent of the traced window's steps in which the card would idle
untraced: its busy time over the same steps' time in the untraced grids."""
from twinbench.spans import idle_untraced as read  # noqa: F401
