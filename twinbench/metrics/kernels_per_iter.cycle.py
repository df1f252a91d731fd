"""Device kernels a drain iteration in the traced window."""
from twinbench.readers import kernels_per_iter as read  # noqa: F401
