"""Operation ``classify``: Phymm classification of FASTA files against
the whole database's genome ICMs, through ``classify_file``'s per-file
path with the bank built once at set-up (``PhymmBank.from_genome_data``):
``read_fasta``, ``PhymmBank.score_reads(batch=512)`` with the progress
file, ``write_raw_phymm_output`` and ``write_results_table``, as
``classify_file`` calls them.

Traffic keys: ``pool_reads`` (reads made at set-up, written as FASTA
files of ``file_reads`` each), ``warmup_reads``, ``check_per_file``
(reads a written file is checked on), ``fasta_width`` (bases a line),
``check_file_share`` (the chance, drawn from the seed, that a file the
window wrote is kept for the check; 1 when absent).

The window deletes each pair of output files it does not keep as soon as
it is written, before the page cache writes it back, so that a run
writes about a GB to disk and not every file of the window (PERF.md §6).
"""

from __future__ import annotations

import os
import time

import numpy as np

from benchmark.lib import counts, database
from benchmark.traffic.reads import make_reads


def write_fasta(path, reads, width):
    with open(path, "w") as fh:
        for h, s in reads:
            fh.write(">" + h + "\n")
            for i in range(0, len(s), width):
                fh.write(s[i:i + width] + "\n")


class Op:
    operation = "classify"

    def __init__(self, ctx):
        self.ctx = ctx
        self.t = ctx.traffic
        if ctx.control not in (None, "int8"):
            raise ValueError(f"classify has no control {ctx.control!r}")

    def setup(self):
        from glimmer_mg_torch.parallel import phymm

        ctx = self.ctx
        self.phymm = phymm
        self.db = database.ensure(ctx.config, ctx.cache_dir, ctx.log)
        self.bank = phymm.PhymmBank.from_genome_data(self.db.icm_dir,
                                                     ctx.device)
        self.taxonomy = phymm.load_taxonomy(self.db.icm_dir)
        if ctx.control == "int8":
            self._int8_tables()
        rng = np.random.default_rng(ctx.seed)
        spec, width = ctx.config["reads"], self.t["fasta_width"]
        reads, _cls, _q = make_reads(self.db, spec, self.t["pool_reads"], rng)
        self.in_dir = os.path.join(ctx.tmp_dir, "in")
        self.out_dir = os.path.join(ctx.tmp_dir, "out")
        os.makedirs(self.in_dir)
        os.makedirs(self.out_dir)
        n = self.t["file_reads"]
        self.files = []  # (path, reads)
        for k, lo in enumerate(range(0, len(reads), n)):
            path = os.path.join(self.in_dir, f"sample{k:03d}.fasta")
            write_fasta(path, reads[lo:lo + n], width)
            self.files.append((path, len(reads[lo:lo + n])))
        self.lengths = {h: len(s) for h, s in reads}
        longest = max(range(len(reads)), key=lambda i: len(reads[i][1]))
        self.longest_file = longest // n
        ctx.log(f"bytes written at set-up (the pool's FASTA files) "
                f"{sum(os.path.getsize(p) for p, _n in self.files)}")
        warm, _c, _q = make_reads(self.db, spec, self.t["warmup_reads"], rng,
                                  prefix="w")
        path = os.path.join(self.in_dir, "warmup.fasta")
        write_fasta(path, warm, width)
        for p in self._one_file(path, "warmup")[:2]:
            os.remove(p)
        ctx.sync()

    def _int8_tables(self):
        """The control: the bank walked over the 8-bit tables the program
        packs (``pack_tables_int8``), for this run only."""
        import torch

        from glimmer_mg_torch.ops import icm_cuda
        from glimmer_mg_torch.parallel import classify as pclassify

        b = self.bank
        parts = [icm_cuda.pack_tables_int8(b.mip[i:i + 16], b.probs[i:i + 16],
                                           depth=b.depth)
                 for i in range(0, len(b.paths), 16)]
        b.tables = tuple(torch.from_numpy(np.concatenate(
            [pt[j] for pt in parts])).to(b.device) for j in (0, 1))
        scale = parts[0][2]

        def step(level_mip, probs_pk, reads, lengths, model_len=12, depth=7):
            return pclassify._with_best(icm_cuda.bank_score_both_strands(
                level_mip, probs_pk, reads, lengths, model_len, depth,
                int8=True, scale=scale))

        self._restore = (pclassify, pclassify.classify_step_kernel)
        pclassify.classify_step_kernel = step

    def _one_file(self, sequence_file, tag):
        """classify_file's path after its bank build; returns the paths it
        wrote (raw matrix, results table, progress file)."""
        from glimmer_mg_torch.io.fasta import read_fasta
        from glimmer_mg_torch.utils.observe import ProgressLog

        phymm = self.phymm
        recs = list(read_fasta(sequence_file))
        read_ids = [h.split()[0] for h, _ in recs]
        base = f"{tag}_" + os.path.basename(sequence_file).replace(".", "_")
        prog = os.path.join(self.out_dir, f"{base}_progress.txt")
        progress = ProgressLog(prog, len(recs), every=50)
        scores = self.bank.score_reads([s.lower() for _, s in recs],
                                       batch=512, progress=progress)
        raw = os.path.join(self.out_dir, phymm.raw_phymm_name(base))
        table = os.path.join(self.out_dir, phymm.results_name(base))
        phymm.write_raw_phymm_output(raw, self.bank.paths, read_ids, scores)
        phymm.write_results_table(table, read_ids, self.bank.paths, scores,
                                  self.taxonomy)
        return raw, table, prog

    def spans(self):
        """The harness's wrappers that keep a launch record: K2's and KT's
        byte counts. The layers' times are the program's own spans."""
        from glimmer_mg_torch.ops import icm_cuda, raw_text_cuda

        def keep_k2(local, res, level_mip, probs_pk, reads, lengths, *a,
                    **kw):
            return counts.k2_record(level_mip, probs_pk, reads, lengths, res)

        def keep_kt(local, res, scores):
            if scores.device.type != "cuda":  # the plain loop, not KT
                return None
            return counts.kt_record(scores, res)

        return [(icm_cuda, "bank_score_both_strands", "k2", keep_k2),
                (raw_text_cuda, "rows_text", "kt", keep_kt)]

    def counters(self):
        from glimmer_mg_torch.utils import observe

        return observe.snapshot()["counters"]

    def window(self, seconds, opened=lambda: None, closed=lambda: None):
        """Classify the pool's files in turn (again from the first if they
        run out) until the first file that ends after ``seconds``."""
        self.written = []  # (input file, raw, table) kept for the check
        keep_rng = np.random.default_rng([self.ctx.seed, 2])
        share = self.t.get("check_file_share", 1.0)
        count = fed_twice = written = 0
        longest_kept = False
        opened()
        t0 = time.perf_counter()
        end = t0 + seconds
        k = 0
        marks = [t0]
        while True:
            src, n = self.files[k % len(self.files)]
            raw, table, prog = self._one_file(src, f"w{k:04d}")
            os.remove(prog)
            written += os.path.getsize(raw) + os.path.getsize(table)
            last = time.perf_counter() >= end
            # kept: a seeded share, the first with the longest read, the last
            holds = k % len(self.files) == self.longest_file
            keep = (keep_rng.random() < share or last
                    or (holds and not longest_kept))
            if keep:
                longest_kept |= holds
                self.written.append((src, raw, table))
            else:
                os.remove(raw)
                os.remove(table)
            count += n
            fed_twice += n if k >= len(self.files) else 0
            k += 1
            marks.append(time.perf_counter())
            if last:
                break
        t1 = marks[-1]
        closed()
        self.ctx.log("seconds a file in the window: " + " ".join(
            f"{b - a:.4f}" for a, b in zip(marks, marks[1:])))
        kept = sum(os.path.getsize(p) for _s, r, t in self.written
                   for p in (r, t))
        self.ctx.log(f"files kept for the check {len(self.written)} of {k}, "
                     f"{kept} bytes")
        return {"count": count, "seconds": t1 - t0, "fed_twice": fed_twice,
                "attempted": count, "failed": 0, "bytes_written": written}

    @staticmethod
    def end_to_end(w):
        """The line's metrics of the window ``w``: reads whose scores
        reached both output files, over the window (host clock)."""
        return {"classify_reads_per_s": {"value": w["count"] / w["seconds"],
                                         "unit": "reads/s"}}

    def release(self):
        self.bank = None
        if getattr(self, "_restore", None) is not None:
            mod, fn = self._restore
            mod.classify_step_kernel = fn
            self._restore = None

    def check(self):
        from benchmark.reference import classify as ref

        try:
            return ref.check(self.db.icm_dir, self.written, self.lengths,
                             self.t["check_per_file"],
                             np.random.default_rng([self.ctx.seed, 1]),
                             self.ctx.device, self.ctx.log)
        finally:
            for _s, raw, table in self.written:
                for p in (raw, table):
                    if os.path.exists(p):
                        os.remove(p)
