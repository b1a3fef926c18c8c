"""Spans and launch records of the traced run, from the harness's wrappers
around entry functions: a kernel's launch records (its byte counts), and
the prediction layers' times until their cell reads the program's own
spans (``lib/program.py`` reads those).

A wrapper records (name, thread, start, end) on the host clock, under a
``torch.profiler.record_function`` of the same name so that the device
trace can be read against it, and may keep a record of the call (the
byte count of a kernel launch, evaluated after the window). The
recorder is active from before the window opens, since a layer's call
may span the opening; a span counts as far as it lies inside the window
(``opened`` to ``closed``), a record where its call began inside it.
"""

from __future__ import annotations

import collections
import threading
import time


class Recorder:
    def __init__(self):
        self.active = False
        self.t_open = self.t_close = None  # the window, host clock
        self.spans = []  # (name, thread ident, t0, t1)
        self.records = collections.defaultdict(list)  # name: [(t0, kept)]
        self.local = threading.local()
        self._saved = []

    def wrap(self, obj, attr, name, keep=None):
        """Wrap ``obj.attr``; ``keep(local, result, *args, **kw)``, when
        given, returns what to keep of each call made in the window (None
        keeps nothing; ``local`` is the recorder's thread-local store)."""
        import torch

        fn = getattr(obj, attr)
        rec = self

        def run(*a, **kw):
            if not rec.active:
                return fn(*a, **kw)
            t0 = time.perf_counter()
            with torch.profiler.record_function(name):
                res = fn(*a, **kw)
            rec.spans.append((name, threading.get_ident(), t0,
                              time.perf_counter()))
            kept = None if keep is None else keep(rec.local, res, *a, **kw)
            if kept is not None:
                rec.records[name].append((t0, kept))
            return res

        self._saved.append((obj, attr, fn))
        setattr(obj, attr, run)

    def restore(self):
        for obj, attr, fn in reversed(self._saved):
            setattr(obj, attr, fn)
        self._saved.clear()

    def opened(self):
        self.t_open = time.perf_counter()

    def closed(self):
        self.t_close = time.perf_counter()
        self.active = False

    def seconds(self) -> dict:
        """Seconds of each span name inside the window, summed over
        threads; a name entered only outside it is left out."""
        out = {}
        for name, _tid, t0, t1 in self.spans:
            if t1 >= self.t_open and t0 <= self.t_close:
                out[name] = out.get(name, 0.0) + (
                    min(t1, self.t_close) - max(t0, self.t_open))
        return out

    def kept(self) -> dict:
        """What was kept of each call that began inside the window."""
        return {name: [k for t0, k in recs
                       if self.t_open <= t0 <= self.t_close]
                for name, recs in self.records.items()}
