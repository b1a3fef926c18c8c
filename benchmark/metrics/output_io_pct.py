"""Share of the window writing classification's files, the program's parts
phymm.raw_matrix.io and phymm.results_table.io (writes and close) and its
span phymm.progress (the progress file), host clock."""

from benchmark.metrics._share import program_pct

UNIT = "%"


def read(t):
    return program_pct(t, "phymm.raw_matrix.io", "phymm.results_table.io",
                       "phymm.progress")
