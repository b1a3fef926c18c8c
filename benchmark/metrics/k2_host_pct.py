"""Share of the window in K2's host side, the program's spans
phymm.score.pad (score_reads' encoding and uploads), k2.check (the range
check and its sync) and k2.launch, host clock."""

from benchmark.metrics._share import program_pct

UNIT = "%"


def read(t):
    return program_pct(t, "phymm.score.pad", "k2.check", "k2.launch")
