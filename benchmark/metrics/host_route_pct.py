"""Share of the reads predicted in the window that the chunk router sent to the
exact host engine (the program's counters: host_reads over device, native
and host reads)."""

UNIT = "%"


def read(t):
    c = t.counters
    if t.operation != "predict":
        return None
    total = c.get("device_reads", 0) + c.get("native_reads", 0) + \
        c.get("host_reads", 0)
    if total == 0:
        return None
    return 100.0 * c.get("host_reads", 0) / total
