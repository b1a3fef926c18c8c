"""K1 (csrc/six_frame.cu): its launches' bytes over 3.35 TB/s, as a share of
its device time in the window."""

from benchmark.metrics._share import roofline_pct

UNIT = "%"


def read(t):
    return roofline_pct(t, "k1")
