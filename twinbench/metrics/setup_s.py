"""Set-up seconds: start of the process to the start of the window."""
from twinbench.readers import setup_s as read  # noqa: F401
