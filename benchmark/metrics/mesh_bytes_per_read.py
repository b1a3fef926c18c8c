"""Bytes that rank 0's collectives sent and received in the window (the
program's counter mesh_bytes) over the reads classified in it; None where
the program counted none."""

UNIT = "bytes/read"


def read(t):
    if "mesh_bytes" not in t.counters or not t.reads:
        return None
    return t.counters["mesh_bytes"] / t.reads
