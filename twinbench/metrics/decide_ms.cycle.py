"""Milliseconds a cycle's decide takes: the twin's own clock around it,
ending in the run-mask read."""
from twinbench.readers import mean_ms


def read(run):
    return mean_ms(run, "decide")
