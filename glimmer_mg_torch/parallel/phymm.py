"""Phymm read classification against a genome ICM bank, on a chosen device.

Counterpart of ``glimmer_mg_tpu.parallel.phymm`` without its mesh branch.
The reference pipeline (scripts/phymm_par.py + scripts/scoreReadsGlim.pl)
fans out processes, each running `simple-score -N <icm>` over all reads
forward and reverse-complement, keeping the per-read max, then merges
score matrices from files. Here the whole bank is a stack of tables on the
device, scored in one launch per read batch and strand by the bank-walk
kernel (``csrc/bank_walk.cu``); the "merge" is the per-read argmax.

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

from glimmer_mg_tpu.models import icm as icm_mod

from ..engine.glimmer_mg import _check_device
from ..ops import icm_cuda, icm_score
from . import classify as pclassify

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
    """A stacked ICM bank with its bank-walk tables on ``device``."""

    def __init__(self, icm_paths: list[str], device):
        self.paths = list(icm_paths)
        self.device = _check_device(device)
        icms = [icm_mod.read_icm(p) for p in self.paths]
        self.model_len = icms[0].model_len
        self.depth = max(m.model_depth for m in icms)
        self.mip, self.probs = icm_score.stack_bank(icms)
        # pack_tables works model by model, so packing in chunks and
        # concatenating gives the same tables
        parts = [icm_cuda.pack_tables(self.mip[i:i + PACK_CHUNK],
                                      self.probs[i:i + PACK_CHUNK],
                                      depth=self.depth)
                 for i in range(0, len(icms), PACK_CHUNK)]
        self.tables = tuple(
            torch.from_numpy(np.concatenate(t)).to(self.device)
            for t in zip(*parts))
        self._exact = None

    @classmethod
    def from_genome_data(cls, icm_dir: str, device) -> "PhymmBank":
        return cls(genome_icm_paths(icm_dir), device)

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
        """
        n = len(seqs)
        out = np.zeros((n, len(self.paths)), dtype=np.float32)
        length = max((len(s) for s in seqs), default=0)
        length = max(3, length + (-length) % 3)  # the kernel needs L % 3 == 0
        for lo in range(0, n, batch):
            chunk = seqs[lo : lo + batch]
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
            out[lo : lo + len(chunk)] = scores.cpu().numpy()
            if progress is not None:
                progress.advance(len(chunk))
        return out


def write_raw_phymm_output(path, icm_paths, read_ids, scores) -> None:
    """scoreReadsGlim.pl raw matrix: one DATA row per ICM across reads."""
    with open(path, "w") as fh:
        fh.write("BEGIN_ICM_LIST\n")
        for p in icm_paths:
            fh.write(p + "\n")
        fh.write("END_ICM_LIST\nBEGIN_READID_LIST\n")
        for r in read_ids:
            fh.write(r + "\n")
        fh.write("END_READID_LIST\nBEGIN_DATA_MATRIX\n")
        for g in range(len(icm_paths)):
            fh.write(" ".join("%.4f" % s for s in scores[:, g]) + "\n")
        fh.write("END_DATA_MATRIX\n")


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
    (genus, family, order, class, phylum); unknown ranks are left blank."""
    best = np.argmax(scores, axis=1)
    with open(path, "w") as fh:
        fh.write("QUERY_ID\tBEST_MATCH\tSCORE\tGENUS\tFAMILY\tORDER\tCLASS\tPHYLUM\n")
        for i, rid in enumerate(read_ids):
            genome = path_to_genome(icm_paths[best[i]])
            strain = genome.split("|")[0]
            ranks = (taxonomy or {}).get(strain, ("", "", "", "", ""))
            fh.write(
                "%s\t%s\t%.4f\t%s\n"
                % (rid, strain, scores[i, best[i]], "\t".join(ranks))
            )


def classify_file(sequence_file, icm_dir, out_dir=".", *, device,
                  taxonomy=None, batch: int = 512):
    """Full classification step on ``device``: score + write the raw
    matrix + the results table. Returns (icm_paths, read_ids, scores)."""
    from glimmer_mg_tpu.io.fasta import read_fasta
    from glimmer_mg_tpu.utils.observe import ProgressLog, vlog

    recs = list(read_fasta(sequence_file))
    read_ids = [h.split()[0] for h, _ in recs]
    if taxonomy is None:
        taxonomy = load_taxonomy(icm_dir)
    bank = PhymmBank.from_genome_data(icm_dir, device)
    vlog(1, f"[phymm] {len(bank.paths)} ICMs x {len(recs)} reads")
    base = os.path.basename(sequence_file).replace(".", "_")
    progress = ProgressLog(os.path.join(out_dir, f"{base}_progress.txt"),
                           len(recs), every=50)
    scores = bank.score_reads([s.lower() for _, s in recs], batch=batch,
                              progress=progress)
    write_raw_phymm_output(
        os.path.join(out_dir, raw_phymm_name(sequence_file)),
        bank.paths, read_ids, scores,
    )
    write_results_table(
        os.path.join(out_dir, results_name(sequence_file)),
        read_ids, bank.paths, scores, taxonomy,
    )
    return bank.paths, read_ids, scores
