"""Share of the window making classification's output text, the program's
parts phymm.raw_matrix.text (on a card: the upload, KT, the download) and
phymm.results_table.text, host clock."""

from benchmark.metrics._share import program_pct

UNIT = "%"


def read(t):
    return program_pct(t, "phymm.raw_matrix.text",
                       "phymm.results_table.text")
