"""GiB of device memory one grid allocates at its peak."""
from twinbench.readers import peak_gib as read  # noqa: F401
