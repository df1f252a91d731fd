"""Per cent of the traced drain window in which no device op ran."""
from twinbench.readers import idle_share as read  # noqa: F401
