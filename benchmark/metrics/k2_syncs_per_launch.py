"""The host's waits on the device a K2 launch: the program's counters
k2_host_syncs over bank_walk_launches in the window, or None where K2 did
not launch (the CPU twin counts syncs but no launch)."""

UNIT = "syncs"


def read(t):
    launches = t.counters.get("bank_walk_launches", 0)
    if not launches:
        return None
    return t.counters.get("k2_host_syncs", 0) / launches
