"""K1's share of its HBM bound in the traced drain window, per cent."""
from twinbench.readers import k1_roofline as read  # noqa: F401
