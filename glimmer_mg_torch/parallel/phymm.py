"""Phymm read classification against a genome ICM bank, on a chosen device.

Counterpart of ``glimmer_mg_tpu.parallel.phymm``. The reference pipeline
(scripts/phymm_par.py + scripts/scoreReadsGlim.pl) fans out processes,
each running `simple-score -N <icm>` over all reads forward and
reverse-complement, keeping the per-read max, then merges score matrices
from files. Here the whole bank is a stack of tables on the device, scored
in one launch per read batch, both strands, by the bank-walk kernel
(``csrc/bank_walk.cu``); the "merge" is the per-read argmax. Over a
(data, model) mesh of ranks (``parallel.mesh``) each rank holds its slice
of the bank and scores its slice of each batch, and the blocks are
all-gathered: the reference's two fan-out modes at once.

File-format parity: writes and reads the reference's rawPhymmOutput_*.txt
(BEGIN_ICM_LIST / BEGIN_READID_LIST / BEGIN_DATA_MATRIX, one row per ICM;
scoreReadsGlim.pl:376-555) and the results.01.phymm_*.txt best-hit table.
The file helpers are copies of the JAX package's: its module imports JAX.
"""

from __future__ import annotations

import glob
import os

import numpy as np
import torch

from ..engine.glimmer_mg import _check_device
from ..models import icm as icm_mod
from ..ops import icm_cuda, icm_score, raw_text_cuda
from ..utils import observe
from . import classify as pclassify
from . import mesh as pmesh

# models packed per pack_tables call: the packing's int64/f32 temporaries
# of a whole 512-model bank come to a few GB of host memory
PACK_CHUNK = 16


def genome_icm_paths(icm_dir: str) -> list[str]:
    """All whole-genome Phymm ICMs (<dir>/<strain>/<nc>.icm), sorted like
    the reference's `sort { $a cmp $b }` over full paths."""
    return sorted(glob.glob(os.path.join(icm_dir, "*", "*.icm")))


def path_to_genome(path: str) -> str:
    """ICM path -> 'strain|nc' (parse_phymm, glimmer-mg.py:556-559)."""
    parts = path.split("/")
    return "%s|%s" % (parts[-2], parts[-1].split(".")[0])


class PhymmBank:
    """A stacked ICM bank with its bank-walk tables on ``device``.

    With ``mesh`` (a ``parallel.mesh`` (data, model) mesh) the bank is
    padded to a multiple of the model axis with repeats of model 0, and
    ``tables`` holds only this rank's slice of it along ``model``."""

    def __init__(self, icm_paths: list[str], device, mesh=None):
        self.paths = list(icm_paths)
        self.device = _check_device(device)
        self.mesh = mesh
        with observe.span("phymm.bank.read", icms=len(self.paths)):
            icms = [icm_mod.read_icm(p) for p in self.paths]
        self.model_len = icms[0].model_len
        self.depth = max(m.model_depth for m in icms)
        with observe.span("phymm.bank.stack"):
            self.mip, self.probs = icm_score.stack_bank(icms)
        mip, probs = self.mip, self.probs
        rows = slice(0, len(icms))
        if mesh is not None:
            mip, probs = pmesh.pad_models(mesh, mip, probs)
            rows = pmesh.model_rows(mesh, mip.shape[0])
        # pack_tables works model by model, so packing in chunks and
        # concatenating gives the same tables
        with observe.span("phymm.bank.pack"):
            parts = [icm_cuda.pack_tables(
                mip[i:min(i + PACK_CHUNK, rows.stop)],
                probs[i:min(i + PACK_CHUNK, rows.stop)], depth=self.depth)
                for i in range(rows.start, rows.stop, PACK_CHUNK)]
            host = [np.concatenate(t) for t in zip(*parts)]
        with observe.span("phymm.bank.upload",
                          bytes=sum(t.nbytes for t in host)):
            self.tables = tuple(torch.from_numpy(t).to(self.device)
                                for t in host)
        self._exact = None

    @classmethod
    def from_genome_data(cls, icm_dir: str, device, mesh=None) -> "PhymmBank":
        return cls(genome_icm_paths(icm_dir), device, mesh)

    def exact_tables(self):
        """The f32 (mip, probs) bank on the device, uploaded at first use."""
        if self._exact is None:
            self._exact = (torch.from_numpy(self.mip).to(self.device),
                           torch.from_numpy(self.probs).to(self.device))
        return self._exact

    def score_reads(self, seqs: list[str], batch: int = 512,
                    use_kernel: bool = True, progress=None):
        """(n_reads, n_models) fwd/rev-max scores, numpy f32.

        Reads are padded per call to the longest read, rounded up to a
        multiple of 3. ``use_kernel`` scores with the 16-bit bank walk
        (the CUDA kernel on a CUDA device, its twin on the CPU), else with
        the exact f32 walk. ``progress`` is an optional
        utils.observe.ProgressLog advanced once per read (the reference's
        *_progress.txt, scoreReadsGlim.pl:417).

        With the bank's mesh, each batch is zero-padded to a multiple of
        the data axis and sharded over it, scored against the rank's model
        slice (``classify_step_kernel_sharded``) and gathered; the pad
        rows and models are sliced off. Every rank returns all the scores.
        The mesh shards the kernel route only.
        """
        if self.mesh is not None and not use_kernel:
            raise ValueError("a mesh shards the bank-walk kernel route only")
        with observe.span("phymm.score", reads=len(seqs)):
            return self._score(seqs, batch, use_kernel, progress)

    def _score(self, seqs, batch, use_kernel, progress):
        """score_reads' batches: spans ``phymm.score.pad`` (the encoding
        and the upload), ``.fetch`` (the blocking download) and
        ``phymm.progress``. A bank-walk batch adds its three blocking
        copies to ``k2_host_syncs``; K2's range check adds the fourth."""
        m = len(self.paths)
        n = len(seqs)
        out = np.zeros((n, m), dtype=np.float32)
        length = max((len(s) for s in seqs), default=0)
        length = max(3, length + (-length) % 3)  # the kernel needs L % 3 == 0
        for lo in range(0, n, batch):
            chunk = seqs[lo : lo + batch]
            if self.mesh is not None:
                reads, lengths = pclassify.pad_reads(chunk, length=length)
                reads, lengths, _n = pmesh.pad_batch(self.mesh, reads,
                                                     lengths)
                scores, _ = pclassify.classify_step_kernel_sharded(
                    self.mesh, *self.tables,
                    *pmesh.shard_reads(self.mesh, reads, lengths,
                                       self.device),
                    self.model_len, self.depth)
                out[lo : lo + len(chunk)] = scores[: len(chunk), :m]
                if progress is not None:
                    progress.advance(len(chunk))
                continue
            with observe.span("phymm.score.pad", reads=len(chunk)):
                reads, lengths = pclassify.pad_reads(chunk, length=length)
                reads = torch.from_numpy(reads).to(self.device)
                lengths = torch.from_numpy(lengths).to(self.device)
            if use_kernel:
                scores, _ = pclassify.classify_step_kernel(
                    *self.tables, reads, lengths, self.model_len, self.depth)
            else:
                scores, _ = pclassify.classify_step(
                    *self.exact_tables(), reads, lengths, self.model_len,
                    self.depth)
            with observe.span("phymm.score.fetch"):
                out[lo : lo + len(chunk)] = scores.cpu().numpy()
            if use_kernel:
                # a copy from pageable memory waits for the stream: the two
                # uploads and the fetch
                observe.count("k2_host_syncs", 3)
            if progress is not None:
                with observe.span("phymm.progress"):
                    progress.advance(len(chunk))
        return out


def write_raw_phymm_output(path, icm_paths, read_ids, scores) -> None:
    """scoreReadsGlim.pl raw matrix: one DATA row per ICM across reads.
    The rows' ``%.4f`` text comes from ``ops.raw_text_cuda``: rendered on
    the card for a float32 matrix when CUDA is available, else by its
    plain loop (a float64 matrix, or no card); both give the same bytes.
    The route follows the matrix and the machine, not the device the
    caller scored on: a float32 matrix scored on the CPU of a machine with
    a card still goes through the card and the kernel library, for the
    price of an upload (blocking, from pageable memory) and two syncs.
    Span ``phymm.raw_matrix``, its parts ``.text`` (the rows' text: on the
    card its upload, kernels and download) and ``.io`` (the writes and the
    close); counter ``raw_matrix_bytes``."""
    with observe.span("phymm.raw_matrix", rows=len(icm_paths),
                      reads=len(read_ids)) as sp, open(path, "w") as fh:
        with sp.part("text"):
            t = torch.from_numpy(np.ascontiguousarray(scores))
            if t.dtype == torch.float32 and torch.cuda.is_available():
                t = t.to("cuda")
            body = raw_text_cuda.rows_text(t)
        with sp.part("io"):
            fh.write("".join(["BEGIN_ICM_LIST\n"]
                             + [p + "\n" for p in icm_paths]
                             + ["END_ICM_LIST\nBEGIN_READID_LIST\n"]
                             + [r + "\n" for r in read_ids]
                             + ["END_READID_LIST\nBEGIN_DATA_MATRIX\n"]))
            fh.flush()
            fh.buffer.write(body)
            fh.write("END_DATA_MATRIX\n")
            if observe.enabled():
                observe.count("raw_matrix_bytes", fh.tell())
            fh.close()


def read_raw_phymm_output(path):
    """Returns (icm_paths, read_ids, scores (n_reads, n_models))."""
    with open(path) as fh:
        lines = fh.read().splitlines()
    it = iter(lines)
    assert next(it) == "BEGIN_ICM_LIST"
    icm_paths = []
    for line in it:
        if line.startswith("END_ICM_LIST"):
            break
        icm_paths.append(line)
    assert next(it) == "BEGIN_READID_LIST"
    read_ids = []
    for line in it:
        if line.startswith("END_READID_LIST"):
            break
        read_ids.append(line)
    assert next(it) == "BEGIN_DATA_MATRIX"
    rows = []
    for line in it:
        if line.startswith("END_DATA_MATRIX"):
            break
        rows.append([float(x) for x in line.split()])
    scores = np.array(rows, dtype=np.float64).T  # (reads, models)
    return icm_paths, read_ids, scores


def raw_phymm_name(sequence_file: str) -> str:
    """rawPhymmOutput_<basename with . -> _>.txt (scoreReadsGlim.pl:376)."""
    base = os.path.basename(sequence_file).replace(".", "_")
    return f"rawPhymmOutput_{base}.txt"


def results_name(sequence_file: str) -> str:
    base = os.path.basename(sequence_file).replace(".", "_")
    return f"results.01.phymm_{base}.txt"


#: Taxonomy ranks in results-table column order (scoreReadsGlim.pl:571).
RANKS = ("genus", "family", "order", "class", "phylum")


def load_taxonomy(icm_dir: str) -> dict[str, tuple[str, ...]]:
    """Load the Phymm taxonomy table for a genome DB.

    Mirrors scoreReadsGlim.pl:296-340: the DB root (the directory holding
    the ``.genomeData`` tree, i.e. ``icm_dir/..``) may carry
    ``.taxonomyData/.3_parsedTaxData/distributionOfTaxa.txt`` (plus a
    ``_userAdded`` variant) with lines

        <taxType> \\t <taxValue> \\t <prefix + species> \\t <strainDirName>

    Only the five ranks in :data:`RANKS` are kept. Returns
    strain -> (genus, family, order, class, phylum); missing ranks are "".
    An absent table yields {} (ranks blank, clustering falls back to
    per-strain granularity).
    """
    root = os.path.dirname(os.path.abspath(icm_dir))
    base = os.path.join(root, ".taxonomyData", ".3_parsedTaxData")
    tax: dict[str, dict[str, str]] = {}
    for name in ("distributionOfTaxa.txt", "distributionOfTaxa_userAdded.txt"):
        path = os.path.join(base, name)
        if not os.path.exists(path):
            continue
        with open(path) as fh:
            for line in fh:
                if not line[:1].strip():
                    continue
                toks = line.rstrip("\n").split("\t")
                if len(toks) >= 4 and toks[0] in RANKS:
                    tax.setdefault(toks[3], {})[toks[0]] = toks[1]
    return {s: tuple(d.get(r, "") for r in RANKS) for s, d in tax.items()}


def write_results_table(path, read_ids, icm_paths, scores, taxonomy=None) -> None:
    """Best-hit table (results.01.phymm_*.txt). ``taxonomy`` maps strain ->
    (genus, family, order, class, phylum); unknown ranks are left blank.
    Span ``phymm.results_table``, its parts ``.text`` (the lines, about a
    megabyte a 16,384-read file, made whole: a part a row would cost more
    than the row on a host with slow thread clocks) and ``.io``."""
    with observe.span("phymm.results_table", reads=len(read_ids)) as sp, \
            open(path, "w") as fh:
        with sp.part("text"):
            best = np.argmax(scores, axis=1)
            lines = ["QUERY_ID\tBEST_MATCH\tSCORE\tGENUS\tFAMILY\tORDER\t"
                     "CLASS\tPHYLUM\n"]
            for i, rid in enumerate(read_ids):
                genome = path_to_genome(icm_paths[best[i]])
                strain = genome.split("|")[0]
                ranks = (taxonomy or {}).get(strain, ("", "", "", "", ""))
                lines.append("%s\t%s\t%.4f\t%s\n"
                             % (rid, strain, scores[i, best[i]],
                                "\t".join(ranks)))
        with sp.part("io"):
            fh.writelines(lines)
            fh.close()


def classify_file(sequence_file, icm_dir, out_dir=".", *, device,
                  taxonomy=None, batch: int = 512, mesh=None):
    """Full classification step on ``device``: score + write the raw
    matrix + the results table. Returns (icm_paths, read_ids, scores).

    ``mesh`` shards the bank and the reads over a (data, model) mesh of
    ranks. Every rank returns the whole score matrix; only the output
    process (rank 0) writes the progress file, the raw matrix and the
    results table."""
    from ..io.fasta import read_fasta
    from ..utils.observe import ProgressLog, vlog

    recs = list(read_fasta(sequence_file))
    read_ids = [h.split()[0] for h, _ in recs]
    if taxonomy is None:
        taxonomy = load_taxonomy(icm_dir)
    bank = PhymmBank.from_genome_data(icm_dir, device, mesh)
    vlog(1, f"[phymm] {len(bank.paths)} ICMs x {len(recs)} reads")
    base = os.path.basename(sequence_file).replace(".", "_")
    writer = pmesh.is_output_process()
    progress = None
    if writer:
        progress = ProgressLog(os.path.join(out_dir, f"{base}_progress.txt"),
                               len(recs), every=50)
    scores = bank.score_reads([s.lower() for _, s in recs], batch=batch,
                              progress=progress)
    if writer:
        write_raw_phymm_output(
            os.path.join(out_dir, raw_phymm_name(sequence_file)),
            bank.paths, read_ids, scores,
        )
        write_results_table(
            os.path.join(out_dir, results_name(sequence_file)),
            read_ids, bank.paths, scores, taxonomy,
        )
    return bank.paths, read_ids, scores
