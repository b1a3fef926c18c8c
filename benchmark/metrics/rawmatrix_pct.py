"""Share of the window inside the program's spans phymm.raw_matrix and
phymm.results_table (write_raw_phymm_output and write_results_table,
classification's output: text and writes), host clock."""

from benchmark.metrics._share import program_pct

UNIT = "%"


def read(t):
    return program_pct(t, "phymm.raw_matrix", "phymm.results_table")
