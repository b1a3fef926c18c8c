"""Operation ``classify_dp4``: Phymm classification of FASTA files
read-sharded over a (data, model) mesh of ranks on one host
(``config["mesh"]``), through the program's own
``phymm.classify_file(src, icm_dir, out_dir, bank=, mesh=, batch=)`` on
every rank: each rank reads, encodes, walks and writes its share of each
file, and the scores are gathered once a file.

Rank 0 is this process. Ranks 1.. are processes of
``ops/classify_dp4_rank.py``, started at set-up with the environment a
launcher gives them (``parallel.launch.rank_env``), each on its own card
(in a CPU run, gloo ranks on the CPU). Every rank builds the bank and
classifies the warm-up file at set-up. Before each file rank 0 broadcasts
continue or stop and the file's number, so the window ends at the first
file boundary after ``--seconds`` on every rank together. The ranks'
initialisation and collectives time out after ``TIMEOUT_S``; a rank whose
parent has gone exits; rank 0 ends every other rank by its process id in
``release()``, on any failure of set-up or the window, when a rank fails,
and at exit.

Traffic keys: those of ``classify`` (``pool_reads``, ``file_reads``,
``warmup_reads``, ``check_per_file``, ``fasta_width``,
``check_file_share``) and ``batch_per_rank`` (reads a rank's K2 launch).
The window deletes each pair of output files it does not keep, as
``classify`` does; the check is ``reference/classify.py``'s and
``reference/classify_shards.py``'s on the files kept.
"""

from __future__ import annotations

import atexit
import datetime
import inspect
import json
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np

import benchmark
from benchmark.lib import database
from benchmark.ops import classify as one_card
from benchmark.traffic.reads import make_reads

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(benchmark.__file__)))
TIMEOUT_S = 120  # a rank's rendezvous and each collective
END_S = 30  # rank 0's wait for the other ranks to leave
# the launcher's variables, set in rank 0's environment while it runs
LAUNCH_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE",
               "LOCAL_WORLD_SIZE", "RANK", "LOCAL_RANK")


class Member:
    """One rank's part: its world, its bank and the files it classifies
    (``spec``: the device, the mesh, the database, the files)."""

    def __init__(self, spec):
        self.spec = spec

    def join(self):
        from glimmer_mg_torch.parallel import mesh as pmesh, phymm

        self.phymm, self.pmesh = phymm, pmesh
        if not pmesh.init_distributed(
                device=self.spec["device"],
                timeout=datetime.timedelta(seconds=TIMEOUT_S)):
            raise RuntimeError("no launcher's environment to join")
        self.device = pmesh.rank_device(self.spec["device"])
        m = self.spec["mesh"]
        self.mesh = pmesh.make_mesh(m["data"], m["model"],
                                    device=self.device)

    def build(self):
        icm_dir = self.spec["icm_dir"]
        self.bank = self.phymm.PhymmBank.from_genome_data(
            icm_dir, self.device, self.mesh)
        self.taxonomy = self.phymm.load_taxonomy(icm_dir)
        if self.spec["control"] == "int8":
            one_card.Op._int8_tables(self)

    def order(self, go=0, k=0):
        """Rank 0's (continue, file number), on every rank."""
        import torch
        import torch.distributed as dist

        t = torch.tensor([go, k], dtype=torch.int64)
        if dist.get_backend() == "nccl":
            t = t.to(self.device)
        dist.broadcast(t, src=0)
        return tuple(t.tolist())

    def classify(self, k):
        """The program's classify_file on the window's file ``k`` (the
        warm-up file for -1), every rank into one directory; returns
        (input, output directory)."""
        files = self.spec["files"]
        src = self.spec["warmup"] if k < 0 else files[k % len(files)]
        out = os.path.join(self.spec["out_dir"],
                           "warmup" if k < 0 else f"w{k:04d}")
        os.makedirs(out, exist_ok=True)
        self.phymm.classify_file(src, self.spec["icm_dir"], out,
                                 device=self.device, taxonomy=self.taxonomy,
                                 batch=self.spec["batch"], mesh=self.mesh,
                                 bank=self.bank)
        return src, out


def serve(spec):
    """Ranks 1..: join, build, then classify as rank 0 orders until it
    says stop; exit at once if rank 0's process goes."""
    parent = spec["parent"]

    def orphaned():
        while os.getppid() == parent:
            time.sleep(0.5)
        os._exit(3)

    threading.Thread(target=orphaned, daemon=True).start()
    member = Member(spec)
    member.join()
    try:
        member.build()
        while True:
            go, k = member.order()
            if not go:
                return 0
            member.classify(k)
    finally:
        member.pmesh.destroy()


class Op:
    operation = "classify_dp4"
    spans = one_card.Op.spans
    counters = one_card.Op.counters
    end_to_end = staticmethod(one_card.Op.end_to_end)

    def __init__(self, ctx):
        self.ctx = ctx
        self.t = ctx.traffic
        if ctx.control not in (None, "int8"):
            raise ValueError(f"classify_dp4 has no control {ctx.control!r}")
        self.procs, self.member = [], None
        self.ending = False  # set once rank 0 ends the ranks or says stop
        self.handled = threading.Event()  # rank 0 ended a failed run
        self.saved_env = {}

    # ---- the other ranks ---------------------------------------------------

    def _start_ranks(self, spec, n):
        from glimmer_mg_torch.parallel import launch

        port = launch.free_port()
        path = os.path.join(self.ctx.tmp_dir, "ranks.json")
        with open(path, "w") as fh:
            json.dump(spec, fh)
        atexit.register(self._end_ranks)
        for r in range(1, n):
            log = open(os.path.join(self.ctx.tmp_dir, f"rank{r}.log"), "w")
            self.procs.append(subprocess.Popen(
                [sys.executable, os.path.join(HERE, "classify_dp4_rank.py"),
                 path], stdout=log, stderr=subprocess.STDOUT, cwd=ROOT,
                env=launch.rank_env(r, n, port)))
            log.close()
        self.saved_env = {k: os.environ.get(k) for k in LAUNCH_VARS}
        os.environ.update({k: v for k, v in launch.rank_env(0, n, port,
                                                             {}).items()})
        threading.Thread(target=self._watch, daemon=True).start()

    def _tail(self, r):
        with open(os.path.join(self.ctx.tmp_dir, f"rank{r}.log")) as fh:
            return fh.read()[-3000:]

    def _watch(self):
        """A rank that fails ends every rank: the others by their ids,
        this process when it has not ended the run itself soon after."""
        while not self.ending:
            for r, p in enumerate(self.procs, 1):
                code = p.poll()
                if code and not self.ending:
                    self.ctx.log(f"rank {r} exited with {code}:\n"
                                 f"{self._tail(r)}")
                    self._end_ranks()
                    if not self.handled.wait(10):
                        self.ctx.log("rank 0 ends the run: a rank failed")
                        shutil.rmtree(self.ctx.tmp_dir, ignore_errors=True)
                        os._exit(3)
                    return
            time.sleep(0.2)

    def _end_ranks(self, wait=0.0):
        """End ranks 1.. by their process ids, after ``wait`` seconds for
        them to leave."""
        self.ending = True
        deadline = time.monotonic() + wait
        for p in self.procs:
            while p.poll() is None and time.monotonic() < deadline:
                time.sleep(0.05)
            if p.poll() is None:
                p.kill()
            p.wait()

    # ---- the cell ----------------------------------------------------------

    def setup(self):
        try:
            self._setup()
        except BaseException:
            self._fail()
            raise

    def _setup(self):
        from glimmer_mg_torch.parallel import phymm

        if "bank" not in inspect.signature(phymm.classify_file).parameters:
            raise TypeError("this program's classify_file takes no bank: it "
                            "cannot classify read-sharded with the bank built "
                            "once")
        ctx, t = self.ctx, self.t
        self.phymm = phymm
        self.db = database.ensure(ctx.config, ctx.cache_dir, ctx.log)
        m = ctx.config["mesh"]
        n = m["data"] * m["model"]
        in_dir = os.path.join(ctx.tmp_dir, "in")
        out_dir = os.path.join(ctx.tmp_dir, "out")
        os.makedirs(in_dir)
        os.makedirs(out_dir)
        per = t["file_reads"]
        self.files = [os.path.join(in_dir, f"sample{k:03d}.fasta")
                      for k in range(-(-t["pool_reads"] // per))]
        spec = {"device": ctx.device, "mesh": m, "icm_dir": self.db.icm_dir,
                "files": self.files, "out_dir": out_dir,
                "warmup": os.path.join(in_dir, "warmup.fasta"),
                "batch": t["batch_per_rank"], "control": ctx.control,
                "root": ROOT, "parent": os.getpid()}
        self._start_ranks(spec, n)  # they build their banks meanwhile
        rng = np.random.default_rng(ctx.seed)
        cfg, width = ctx.config["reads"], t["fasta_width"]
        reads, _c, _q = make_reads(self.db, cfg, t["pool_reads"], rng)
        self.counts = []
        for path, lo in zip(self.files, range(0, len(reads), per)):
            one_card.write_fasta(path, reads[lo:lo + per], width)
            self.counts.append(len(reads[lo:lo + per]))
        self.lengths = {h: len(s) for h, s in reads}
        longest = max(range(len(reads)), key=lambda i: len(reads[i][1]))
        self.longest_file = longest // per
        ctx.log(f"bytes written at set-up (the pool's FASTA files) "
                f"{sum(os.path.getsize(p) for p in self.files)}")
        warm, _c, _q = make_reads(self.db, cfg, t["warmup_reads"], rng,
                                  prefix="w")
        one_card.write_fasta(spec["warmup"], warm, width)
        self.member = Member(spec)
        self.member.join()
        self.member.build()
        self.member.order(1, -1)
        src, out = self.member.classify(-1)
        self._remove(src, out)
        ctx.sync()

    def _outputs(self, src, out):
        base = os.path.basename(src).replace(".", "_")
        return (os.path.join(out, self.phymm.raw_phymm_name(src)),
                os.path.join(out, self.phymm.results_name(src)),
                os.path.join(out, f"{base}_progress.txt"))

    def _remove(self, src, out, keep=()):
        for p in self._outputs(src, out):
            if p not in keep and os.path.exists(p):
                os.remove(p)
        if not keep:
            os.rmdir(out)

    def window(self, seconds, opened=lambda: None, closed=lambda: None):
        try:
            return self._window(seconds, opened, closed)
        except BaseException:
            self._fail()
            raise

    def _window(self, seconds, opened, closed):
        """Classify the pool's files in turn (again from the first if they
        run out) on every rank until the first file that ends after
        ``seconds``."""
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
            self.member.order(1, k)
            src, out = self.member.classify(k)
            raw, table, _prog = self._outputs(src, out)
            written += os.path.getsize(raw) + os.path.getsize(table)
            last = time.perf_counter() >= end
            holds = k % len(self.files) == self.longest_file
            keep = (keep_rng.random() < share or last
                    or (holds and not longest_kept))
            if keep:
                longest_kept |= holds
                self.written.append((src, raw, table))
            self._remove(src, out, (raw, table) if keep else ())
            n = self.counts[k % len(self.files)]
            count += n
            fed_twice += n if k >= len(self.files) else 0
            k += 1
            marks.append(time.perf_counter())
            if last:
                break
        t1 = marks[-1]
        closed()
        self.ending = True
        self.member.order(0)
        self.ctx.log("seconds a file in the window: " + " ".join(
            f"{b - a:.4f}" for a, b in zip(marks, marks[1:])))
        kept = sum(os.path.getsize(p) for _s, r, t in self.written
                   for p in (r, t))
        self.ctx.log(f"files kept for the check {len(self.written)} of {k}, "
                     f"{kept} bytes")
        return {"count": count, "seconds": t1 - t0, "fed_twice": fed_twice,
                "attempted": count, "failed": 0, "bytes_written": written}

    def release(self):
        self._end_ranks(wait=END_S)
        for r, p in enumerate(self.procs, 1):
            if p.returncode:
                self.ctx.log(f"rank {r} exited with {p.returncode}:\n"
                             f"{self._tail(r)}")
        self._leave()

    def _fail(self):
        self.handled.set()
        self._end_ranks()
        self._leave()

    def _leave(self):
        """Rank 0 leaves the world; the control's tables and the
        launcher's variables are put back."""
        if self.member is not None:
            if getattr(self.member, "pmesh", None) is not None:
                self.member.pmesh.destroy()
            if getattr(self.member, "_restore", None) is not None:
                mod, fn = self.member._restore
                mod.classify_step_kernel = fn
            self.member = None
        for k, v in self.saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    def check(self):
        from benchmark.reference import classify as ref, classify_shards

        try:
            got = ref.check(self.db.icm_dir, self.written, self.lengths,
                            self.t["check_per_file"],
                            np.random.default_rng([self.ctx.seed, 1]),
                            self.ctx.device, self.ctx.log)
            got.update(classify_shards.check(
                self.db.icm_dir, self.written, self.ctx.config["mesh"]["data"],
                self.ctx.device, self.ctx.log))
            return got
        finally:
            for _s, raw, table in self.written:
                for p in (raw, table):
                    if os.path.exists(p):
                        os.remove(p)
