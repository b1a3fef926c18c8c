"""Share of the window that rank 0 spends in the program's mesh spans
(mesh.offsets, mesh.gather, mesh.barrier: the merge's collectives and the
wait in them for the slowest rank), host clock; None where the program
has no such span."""

from benchmark.metrics._share import program_pct

UNIT = "%"


def read(t):
    return program_pct(t, *[n for n in t.program_spans
                            if n.startswith("mesh.")])
