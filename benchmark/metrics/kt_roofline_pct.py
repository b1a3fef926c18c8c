"""KT (csrc/raw_text.cu, four kernels a launch): its launches' bytes (the
float32 scores in, the text out) over 3.35 TB/s, as a share of its device
time in the window."""

from benchmark.metrics._share import roofline_pct

UNIT = "%"


def read(t):
    return roofline_pct(t, "kt")
