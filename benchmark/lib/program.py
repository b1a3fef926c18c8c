"""The program's own spans (``glimmer_mg_torch.utils.observe``) against
the window of a traced run.

A whole span has an interval of its own, ``[t0, t1]`` on
``time.perf_counter_ns``; a part (``<span>.<part>``, e.g.
``phymm.raw_matrix.text``) is summed pieces of its span, recorded over
the span's interval with only their summed ``wall``. So a whole span
counts as far as it lies inside the window, and a part counts its
``wall`` scaled by the share of its span's interval inside the window.
"""

from __future__ import annotations


def parts(spans) -> set:
    """The records of ``spans`` that are parts: ``<name>.<p>`` on the
    same thread and interval as a record ``<name>``."""
    keys = {(s.name, s.tid, s.t0, s.t1) for s in spans}
    return {i for i, s in enumerate(spans)
            if "." in s.name
            and (s.name.rsplit(".", 1)[0], s.tid, s.t0, s.t1) in keys}


def wholes(spans) -> list:
    """The whole spans of ``spans``, parts left out."""
    skip = parts(spans)
    return [s for i, s in enumerate(spans) if i not in skip]


def _overlap(s, t_open, t_close):
    return max(0, min(s.t1, t_close) - max(s.t0, t_open))


def in_window(spans, t_open, t_close) -> dict:
    """{name: seconds inside the window ``[t_open, t_close]`` (ns)},
    summed over threads; a name with no time inside it is left out."""
    skip = parts(spans)
    out = {}
    for i, s in enumerate(spans):
        inside = _overlap(s, t_open, t_close)
        if i in skip:
            whole = s.t1 - s.t0
            inside = s.wall * (inside / whole) if whole > 0 else (
                s.wall if t_open <= s.t0 <= t_close else 0)
        if inside > 0:
            out[s.name] = out.get(s.name, 0.0) + inside / 1e9
    return out


def before(spans, t_open) -> dict:
    """{name: seconds} of the spans that closed before ``t_open`` (ns)."""
    out = {}
    for s in spans:
        if s.t1 <= t_open:
            out[s.name] = out.get(s.name, 0.0) + s.wall / 1e9
    return out


def unspanned(spans, tid, t_open, t_close) -> float:
    """Seconds of the window in which the thread ``tid`` is inside no
    whole span."""
    iv = sorted((max(s.t0, t_open), min(s.t1, t_close))
                for s in wholes(spans) if s.tid == tid)
    covered, end = 0, t_open
    for a, b in iv:
        a = max(a, end)
        if b > a:
            covered += b - a
            end = b
    return max(0, t_close - t_open - covered) / 1e9
