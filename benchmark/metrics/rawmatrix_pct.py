"""Share of the window inside write_raw_phymm_output and write_results_table
(classification's output text), host clock."""

from benchmark.metrics._share import span_pct

UNIT = "%"


def read(t):
    return span_pct(t, "raw_matrix", "results_table")
