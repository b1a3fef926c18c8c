"""Share of the classification window in which the main thread is inside
none of the program's whole spans (the FASTA read, the lower-casing, the
ids: classify_file's path outside score_reads and the writers), host
clock."""

UNIT = "%"


def read(t):
    if t.operation != "classify" or t.program_window_s <= 0:
        return None
    return 100.0 * t.main_unspanned_s / t.program_window_s
