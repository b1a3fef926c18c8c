"""Share of the prediction window in which nothing ran on the device (1 - the
union of kernels, copies and sets over the window), from the profiler's
trace."""

from benchmark.metrics._share import idle_pct

UNIT = "%"


def read(t):
    return idle_pct(t, "predict")
