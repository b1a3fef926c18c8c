"""Helpers of the metric readers (not a metric: its name starts with _)."""

from benchmark.lib.peaks import HBM_BYTES_PER_S


def span_pct(t, *names):
    """Share of the window inside the spans ``names``, in %, or None
    where none of them was entered."""
    if not any(n in t.spans for n in names):
        return None
    return 100.0 * sum(t.spans.get(n, 0.0) for n in names) / t.host_window_s


def program_pct(t, *names):
    """Share of the window inside the program's spans or parts ``names``
    (clipped to the window, summed over threads), in %, or None where
    none of them has time in the window."""
    if not any(n in t.program_spans for n in names):
        return None
    return (100.0 * sum(t.program_spans.get(n, 0.0) for n in names)
            / t.program_window_s)


def roofline_pct(t, kernel):
    """A kernel's bytes over the HBM peak, as a share of its device time
    in the window, in %, or None where it did not run or its launches and
    the trace's kernels do not pair."""
    nbytes = t.launch_bytes.get(kernel, [])
    secs = t.kernel_s.get(kernel, [])
    if not nbytes or not secs:
        return None
    per_launch = {"k2": 3, "kt": 4}.get(kernel, 1)
    if len(secs) != per_launch * len(nbytes):
        return None
    return 100.0 * sum(nbytes) / HBM_BYTES_PER_S / sum(secs)


def idle_pct(t, operation):
    """Share of the window in which nothing ran on the device, in %, or
    None where the trace saw no device activity at all (a trace that saw
    nothing cannot tell idle from unseen)."""
    if t.operation != operation or t.window_s <= 0 or not t.device_events:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
