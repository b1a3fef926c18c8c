"""Share of the window inside the program's _bank_for (build_bank and
bank_to_device, the chunk's bank build and upload), host clock, summed over
threads."""

from benchmark.metrics._share import span_pct

UNIT = "%"


def read(t):
    return span_pct(t, "bank")
