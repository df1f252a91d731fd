"""Milliseconds a grid spends turning its traces into the program's
scenario tables."""
from twinbench.readers import mean_ms


def read(run):
    return mean_ms(run, "stack")
