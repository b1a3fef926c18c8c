"""Share of the window inside the program's classes_models (the per-read Models
of classes mode), host clock, summed over threads."""

from benchmark.metrics._share import span_pct

UNIT = "%"


def read(t):
    return span_pct(t, "models")
