"""Operation ``predict``: glimmer-mg's classes mode (-c) over the cell's
reads, through the program's ``run_glimmer_mg_classes`` with its
defaults (``engine="device"``, the f64 carry, the chunk overlap its host
sets) but for the mix's ``options``, all of the pool in one call.

Traffic keys: ``pool_reads`` (reads made from the seed at set-up),
``warmup_reads``, ``check_reads`` (reads the reference re-predicts),
``options`` (keyword options of the call, e.g. ``chunk_size``,
``allow_subs``).
"""

from __future__ import annotations

import inspect
import time

import numpy as np

from benchmark.lib import counts, database
from benchmark.traffic.reads import make_reads


class Op:
    operation = "predict"

    def __init__(self, ctx):
        self.ctx = ctx
        self.t = ctx.traffic
        self.use_control(ctx.control)

    # -- set-up ------------------------------------------------------------

    def setup(self):
        from glimmer_mg_torch.engine import glimmer_mg as tmg
        from glimmer_mg_torch.io.genome_data import GenomeData

        ctx = self.ctx
        self.tmg = tmg
        t0 = time.perf_counter()
        self.db = database.ensure(ctx.config, ctx.cache_dir, ctx.log)
        self.gd = GenomeData(self.db.icm_dir)
        rng = self.reseed(ctx.seed)
        reads_spec = ctx.config["reads"]
        # the warm-up: every entry once as a read's first class, so that
        # the program's loaders have seen the whole database, each read
        # repeated to fill the warm-up (a repeat shares its Models and bank
        # row, so the warm-up builds each once)
        base, cls, q = make_reads(self.db, reads_spec, len(self.db.entries),
                                  rng, prefix="w",
                                  entries=np.arange(len(self.db.entries)))
        n_warm = self.t["warmup_reads"]
        warm, warm_cls, warm_q = [], {}, None if q is None else {}
        for i in range(n_warm):
            h, s = base[i % len(base)]
            name = f"{h}_{i // len(base)}"
            warm.append((name, s))
            warm_cls[name] = cls[h]
            if q is not None:
                warm_q[name] = q[h]
        warm = (warm, warm_cls, warm_q)
        self.chunk = self.options.get("chunk_size", inspect.signature(
            tmg.run_glimmer_mg_classes).parameters["chunk_size"].default)
        t1 = time.perf_counter()
        for _ in self._call(*warm):
            pass
        ctx.sync()
        ctx.log(f"set-up parts: database and reads {t1 - t0:.3f} s, warm-up "
                f"{time.perf_counter() - t1:.3f} s")

    def reseed(self, seed):
        """Make the pool of reads of ``seed``; returns the generator, which
        goes on to draw the warm-up."""
        rng = np.random.default_rng(seed)
        self.seed = seed
        self.reads, self.classes, self.quals = make_reads(
            self.db, self.ctx.config["reads"], self.t["pool_reads"], rng)
        return rng

    def use_control(self, control):
        """Switch to the program's lower-precision path (the f32 carry)
        or, with None, back to the cell's own."""
        if control not in (None, "f32"):
            raise ValueError(f"predict has no control {control!r}")
        self.options = dict(self.t.get("options", {}))
        if control == "f32":
            self.options["f64"] = False
        self.control = control

    def _call(self, reads, classes, quals):
        return self.tmg.run_glimmer_mg_classes(
            reads, self.gd, classes, device=self.ctx.device,
            qualities=quals, **self.options)

    # -- the window ----------------------------------------------------------

    def spans(self):
        """(object, attribute, span name, keep) of the traced run."""
        from glimmer_mg_torch.engine import glimmer_mg as tmg
        from glimmer_mg_torch.ops import event_dp_cuda, frontend_cuda
        from glimmer_mg_torch.ops import icm_cuda

        def keep_bank(local, res, rows, models_list, *a, **kw):
            local.models = models_list  # K1's groups, launched next

        def keep_k1(local, res, gm, gp, im, ip, reads, lengths, group, **kw):
            models = getattr(local, "models", None)
            if models is None:  # the chunk's bank was built before the window
                return None
            local.models = None
            return counts.k1_record(reads, lengths, group, models,
                                    kw.get("model_len", 12),
                                    kw.get("depth", 7))

        def keep_kf(local, res, seq, n, gi, g6, i6, bank, Lp, consts,
                    max_events, quals=None):
            ev, n_events = res
            return counts.kf_record(seq, n, gi, g6, i6, bank, Lp, ev,
                                    n_events, quals)

        def keep_k3(local, res, ev, tables, groups, consts, ne):
            return counts.k3_record(ev, tables, groups, ne, res)

        return [(tmg, "classes_models", "models", None),
                (tmg, "_bank_for", "bank", keep_bank),
                (icm_cuda, "mg_six_frame", "k1", keep_k1),
                (frontend_cuda, "frontend", "kf", keep_kf),
                (event_dp_cuda, "event_dp_traceback", "k3", keep_k3),
                (tmg, "_host_predict", "host_engine", None)]

    def counters(self):
        return dict(self.tmg.counters)

    def window(self, seconds, opened=lambda: None, closed=lambda: None):
        """Time the program's steady state. One call is fed the whole pool
        (a new call over it again, should it run out). The program emits a
        chunk's reads together and keeps one chunk in flight, so the
        window opens at the end of the call's first chunk and closes at
        the first chunk boundary after ``seconds``: it counts the reads of
        the chunks emitted in between, over the time between the two
        boundaries. The time before it opens (the pipeline's fill) is the
        run's set-up."""
        self.emitted = {}
        marks = []  # host clock at each chunk boundary, the opening first
        count = fed_twice = passes = 0
        t_call = time.perf_counter()
        gen = None

        def boundary():
            marks.append(time.perf_counter())
            if len(marks) == 1:
                opened()
            return marks[-1] - marks[0] >= seconds

        done = False
        while not done:
            gen = self._call(self.reads, self.classes, self.quals)
            n_call = 0
            for header, genes in gen:
                self.emitted[header] = genes
                n_call += 1
                count += bool(marks)
                fed_twice += passes > 0
                if n_call % self.chunk == 0 and boundary():
                    done = True
                    break
            else:  # the call's last chunk ends at the pool's end
                done = n_call % self.chunk != 0 and boundary()
            passes += 1
        closed()
        gen.close()
        # the chunk in flight on the program's worker thread
        self.tmg._engine_pool().submit(lambda: None).result()
        steps = np.diff(marks)
        self.ctx.log(f"chunks in the window {len(steps)} of {self.chunk} "
                     f"reads, seconds each: min {steps.min():.3f} median "
                     f"{np.median(steps):.3f} max {steps.max():.3f}; the fill "
                     f"{marks[0] - t_call:.3f} s")
        return {"count": count, "seconds": marks[-1] - marks[0],
                "fill_s": marks[0] - t_call, "fed_twice": fed_twice,
                "attempted": count, "failed": 0}

    @staticmethod
    def end_to_end(w):
        """The line's metrics of the window ``w``: the reads of the chunks
        emitted in it over its length (host clock)."""
        return {"predict_reads_per_s": {"value": w["count"] / w["seconds"],
                                        "unit": "reads/s"}}

    def release(self):
        self.tmg = None
        self.gd = None

    # -- the check -----------------------------------------------------------

    def check(self):
        from benchmark.reference import predict as ref

        rng = np.random.default_rng([self.seed, 1])
        names = sorted(self.emitted, key=lambda h: int(h[1:]))
        k = min(self.t["check_reads"], len(names))
        pick = set(rng.choice(len(names), size=k, replace=False).tolist())
        by_name = dict(self.reads)
        longest = max(range(len(names)), key=lambda i: len(by_name[names[i]]))
        pick.add(longest)
        sample = [names[i] for i in sorted(pick)]
        t0 = time.perf_counter()
        res, diag = ref.compare(self.db.icm_dir, [
            (by_name[h], self.classes[h],
             None if self.quals is None else self.quals.get(h),
             ref.plain(self.emitted[h])) for h in sample],
            allow_subs=bool(self.options.get("allow_subs")))
        with_genes = sum(1 for g in self.emitted.values() if g)
        self.ctx.log(f"reads with genes in the window: {with_genes} of "
                     f"{len(self.emitted)}")
        self.ctx.log(f"reference: {len(sample)} reads, {diag['genes']} "
                     f"genes (the longest read "
                     f"{len(by_name[names[longest]])} bp), widest gap as a "
                     f"share of the score {diag['relative_gap']!r}, in "
                     f"{time.perf_counter() - t0:.1f} s")
        return res
