"""Per-layer metric readers, one file each: ``read(trace)`` returns the
value or None, ``UNIT`` its unit."""
