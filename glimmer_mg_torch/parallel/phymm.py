"""Phymm read classification against a genome ICM bank, on a chosen device.

Counterpart of ``glimmer_mg_tpu.parallel.phymm``. The reference pipeline
(scripts/phymm_par.py + scripts/scoreReadsGlim.pl) fans out processes,
each running `simple-score -N <icm>` over all reads forward and
reverse-complement, keeping the per-read max, then merges score matrices
from files. Here the whole bank is a stack of tables on the device, scored
in one launch per read batch, both strands, by the bank-walk kernel
(``csrc/bank_walk.cu``); the "merge" is the per-read argmax. Over a
(data, model) mesh of ranks (``parallel.mesh``) each rank holds its slice
of the bank, reads, scores and writes its share of each file's reads,
and the blocks are all-gathered once a file: the reference's two fan-out
modes at once (``classify_file``).

File-format parity: writes and reads the reference's rawPhymmOutput_*.txt
(BEGIN_ICM_LIST / BEGIN_READID_LIST / BEGIN_DATA_MATRIX, one row per ICM;
scoreReadsGlim.pl:376-555) and the results.01.phymm_*.txt best-hit table.
The file helpers are copies of the JAX package's: its module imports JAX.
"""

from __future__ import annotations

import glob
import locale
import os

import numpy as np
import torch

from ..engine.glimmer_mg import _check_device
from ..models import dna
from ..models import icm as icm_mod
from ..ops import icm_cuda, icm_score, raw_text_cuda
from ..utils import observe
from . import classify as pclassify
from . import mesh as pmesh

# models packed per pack_tables call: the packing's int64/f32 temporaries
# of a whole 512-model bank come to a few GB of host memory
PACK_CHUNK = 16
# reads a slab, rounded down to whole batches (at least one): score_reads
# and score_share encode, upload and pad a slab at once, then launch its
# batches back to back; score_reads downloads it once. Device and pinned
# host memory follow the slab, not the number of reads.
SLAB_READS = 8192

# K2's value check is skipped on the slabs (icm_cuda.values_in_range): every
# base index they hold comes from this table (io.fasta_share's too)
if not 0 <= dna.SUBSCRIPT_TABLE.min() <= dna.SUBSCRIPT_TABLE.max() <= 3:
    raise AssertionError("dna.SUBSCRIPT_TABLE must map every byte to 0..3")


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
        self._subscript = torch.from_numpy(
            dna.SUBSCRIPT_TABLE.astype(np.int32)).to(self.device)
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
        multiple of 3, and walked ``batch`` a launch. ``use_kernel`` scores
        with the 16-bit bank walk (the CUDA kernel on a CUDA device, its
        twin on the CPU), else with the exact f32 walk. ``progress`` is an
        optional utils.observe.ProgressLog advanced as reads are scored
        (the reference's *_progress.txt, scoreReadsGlim.pl:417). A read
        that is not latin-1 text raises UnicodeEncodeError, as
        ``dna.encode`` does.

        A bank on a mesh scores a rank's share through ``score_share``.
        """
        if self.mesh is not None:
            raise ValueError("a bank on a mesh scores through score_share")
        with observe.span("phymm.score", reads=len(seqs)):
            return self._score(seqs, batch, use_kernel, progress)

    def _score(self, seqs, batch, use_kernel, progress):
        """score_reads by slabs of ``_slab_reads(batch)`` reads: spans
        ``phymm.score.pad`` (a slab's encoding, upload and padding),
        ``.fetch`` (its download, the slab's one host wait, counted in
        ``k2_host_syncs`` for the bank walk) and ``phymm.progress``. The
        next slab is encoded while the device walks this one."""
        n = len(seqs)
        out = np.zeros((n, len(self.paths)), dtype=np.float32)
        if not n:
            return out
        length = max(len(s) for s in seqs)
        length = max(3, length + (-length) % 3)  # the kernel needs L % 3 == 0
        per = _slab_reads(batch)
        slab = self._encode(seqs[:per], length)
        for lo in range(0, n, per):
            hi = min(lo + per, n)
            block = torch.empty((hi - lo, out.shape[1]), dtype=torch.float32,
                                device=self.device)
            self._walk(*slab, batch, use_kernel, block)
            if hi < n:
                slab = self._encode(seqs[hi:hi + per], length)
            with observe.span("phymm.score.fetch"):
                # into pageable memory: the copy waits for the stream
                torch.from_numpy(out[lo:hi]).copy_(block)
            if use_kernel:
                observe.count("k2_host_syncs")
            if progress is not None:
                with observe.span("phymm.progress"):
                    progress.advance(hi - lo)
        return out

    def _encode(self, seqs, length):
        """The slab ``seqs`` (str) as (reads (R, ``length``) int32, lengths
        (R,) int32) on the bank's device: the strings joined and encoded as
        latin-1 (as ``dna.encode`` does), uploaded with their lengths in
        one copy, then each byte looked up in ``dna.SUBSCRIPT_TABLE`` and
        scattered to its row there."""
        with observe.span("phymm.score.pad", reads=len(seqs)):
            raw = np.frombuffer("".join(seqs).encode("latin-1"), np.uint8)
            lens, codes = self._upload(
                np.fromiter(map(len, seqs), np.int32, len(seqs)), raw)
            bases = self._subscript.index_select(0, codes.int())
            return self._padded(bases, lens, length), lens

    def _walk(self, reads, lens, batch, use_kernel, into):
        """Fill ``into`` (a slab's rows of scores on the device) from the
        padded slab ``reads``, ``lens``, ``batch`` reads a launch, back to
        back with no host wait: K2 through ``pclassify.classify_step_kernel``
        inside ``icm_cuda.values_in_range`` (every base came from
        ``dna.SUBSCRIPT_TABLE``, no length passes the slab's width), else
        the exact f32 walk."""
        with icm_cuda.values_in_range():
            for lo in range(0, len(lens), batch):
                hi = lo + batch
                if use_kernel:
                    into[lo:hi], _ = pclassify.classify_step_kernel(
                        *self.tables, reads[lo:hi], lens[lo:hi],
                        self.model_len, self.depth)
                else:
                    into[lo:hi], _ = pclassify.classify_step(
                        *self.exact_tables(), reads[lo:hi], lens[lo:hi],
                        self.model_len, self.depth)

    def score_share(self, codes, offsets, batch: int = 512, progress=None):
        """(reads, models of this rank's slice) bank-walk scores of the
        reads ``codes[offsets[i]:offsets[i + 1]]`` (base indices, as
        ``io.fasta_share.read_share`` gives them), a float32 tensor on the
        bank's device; pad models are kept. ``batch`` reads a launch,
        padded to the longest read rounded up to a multiple of 3; no
        download and no host wait. Spans ``phymm.score`` and, a slab of
        ``_slab_reads(batch)`` reads, ``phymm.score.pad`` (its upload and
        its padding on the device) and ``phymm.progress``."""
        n = len(offsets) - 1
        lengths = np.diff(offsets).astype(np.int32)
        length = int(lengths.max()) if n else 0
        length = max(3, length + (-length) % 3)
        out = torch.empty((n, self.tables[0].shape[0]), dtype=torch.float32,
                          device=self.device)
        per = _slab_reads(batch)
        with observe.span("phymm.score", reads=n):
            for lo in range(0, n, per):
                hi = min(lo + per, n)
                with observe.span("phymm.score.pad", reads=hi - lo):
                    lens, bases = self._upload(
                        lengths[lo:hi],
                        codes[offsets[lo]:offsets[hi]].view(np.uint8))
                    reads = self._padded(bases.to(torch.int32), lens, length)
                self._walk(reads, lens, batch, True, out[lo:hi])
                if progress is not None:
                    with observe.span("phymm.progress"):
                        progress.advance(hi - lo)
        return out

    def _upload(self, lengths, codes):
        """``lengths`` (int32) and ``codes`` (a byte a base) on the bank's
        device in one copy, without a host wait: through pinned memory on a
        CUDA device (the caching host allocator keeps the buffer until the
        copy is done); on the CPU, views of the host buffer itself."""
        r = 4 * len(lengths)
        host = torch.empty(r + len(codes), dtype=torch.uint8,
                           pin_memory=self.device.type == "cuda")
        buf = host.numpy()
        buf[:r] = lengths.view(np.uint8)
        buf[r:] = codes
        dev = host.to(self.device, non_blocking=True)
        return dev[:r].view(torch.int32), dev[r:]

    def _padded(self, bases, lens, length):
        """The (R, ``length``) int32 batch of the reads ``bases`` (int32, end
        to end) of ``lens`` (int32), zero-padded, on their device: each base
        scattered to its row without a sync."""
        dev = bases.device
        rep = lens.long()
        # base j of read r goes to r * length + j: a read's shift is its
        # row's start less its first base's place in ``bases``
        shift = (torch.arange(len(lens), device=dev) * length
                 - (torch.cumsum(rep, 0) - rep))
        at = torch.arange(len(bases), device=dev) + torch.repeat_interleave(
            shift, rep, output_size=len(bases))
        reads = torch.zeros((len(lens), length), dtype=torch.int32,
                            device=dev)
        reads.view(-1).scatter_(0, at, bases)
        return reads


def _slab_reads(batch: int) -> int:
    """Reads a slab: ``SLAB_READS`` rounded down to whole batches of
    ``batch``, at least one batch."""
    return batch * max(1, SLAB_READS // batch)


# the raw matrix's fixed lines: before the ICM list, between it and the
# read ids, between them and the data rows, after the rows
_RAW_HEAD = ("BEGIN_ICM_LIST\n", "END_ICM_LIST\nBEGIN_READID_LIST\n",
             "END_READID_LIST\nBEGIN_DATA_MATRIX\n", "END_DATA_MATRIX\n")
_TABLE_HEAD = ("QUERY_ID\tBEST_MATCH\tSCORE\tGENUS\tFAMILY\tORDER\tCLASS\t"
               "PHYLUM\n")


def _rows_text(t):
    """The DATA rows of the (reads, models) matrix ``t`` (a tensor):
    through ``raw_text_cuda.rows_text`` on the card for float32 when CUDA
    is available (a CPU tensor is uploaded first), else its plain loop."""
    if (t.dtype == torch.float32 and t.device.type == "cpu"
            and torch.cuda.is_available()):
        t = t.to("cuda")
    return raw_text_cuda.rows_text(t.contiguous())


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
            body = _rows_text(torch.from_numpy(np.ascontiguousarray(scores)))
        with sp.part("io"):
            fh.write("".join([_RAW_HEAD[0]] + [p + "\n" for p in icm_paths]
                             + [_RAW_HEAD[1]] + [r + "\n" for r in read_ids]
                             + [_RAW_HEAD[2]]))
            fh.flush()
            fh.buffer.write(body)
            fh.write(_RAW_HEAD[3])
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
            lines = [_TABLE_HEAD] + _table_lines(read_ids, icm_paths, scores,
                                                 taxonomy)
        with sp.part("io"):
            fh.writelines(lines)
            fh.close()


def _table_lines(read_ids, icm_paths, scores, taxonomy):
    """The results table's line of each read (its row of ``scores``)."""
    best = np.argmax(scores, axis=1)
    lines = []
    for i, rid in enumerate(read_ids):
        genome = path_to_genome(icm_paths[best[i]])
        strain = genome.split("|")[0]
        ranks = (taxonomy or {}).get(strain, ("", "", "", "", ""))
        lines.append("%s\t%s\t%.4f\t%s\n"
                     % (rid, strain, scores[i, best[i]], "\t".join(ranks)))
    return lines


def classify_file(sequence_file, icm_dir, out_dir=".", *, device,
                  taxonomy=None, batch: int = 512, mesh=None, bank=None):
    """Full classification step on ``device``: score + write the raw
    matrix + the results table. Returns (icm_paths, read_ids, scores).

    ``bank`` is a ``PhymmBank`` of ``icm_dir`` built before, on ``mesh``
    when one is given; without it the bank is built here.

    ``mesh`` splits the reads over its data axis and the bank over its
    model axis. Each rank reads its share of the file
    (``io.fasta_share``: a contiguous byte range cut at record starts),
    encodes it and walks it ``batch`` of its own reads a launch, and the
    score blocks are gathered once (``parallel.mesh.gather_blocks``).
    Every rank returns the whole score matrix and every read id, in the
    file's order, once both files are whole. With more than one rank on
    the data axis and every rank on this host (``parallel.mesh.one_host``)
    the ranks at model coordinate 0 each render their share of the files
    (their block of the raw matrix's ICM rows, their reads' ids and table
    lines) and write it at its offset, so every rank must be given the
    same ``out_dir``; otherwise rank 0 writes both files. Rank 0 writes the
    progress file, which counts its own reads until the gather, then the
    file's. The files are byte for byte the one-rank run's."""
    if taxonomy is None:
        taxonomy = load_taxonomy(icm_dir)
    if bank is None:
        bank = PhymmBank.from_genome_data(icm_dir, device, mesh)
    elif bank.mesh is not mesh:
        raise ValueError("the bank was built on another mesh")
    if mesh is not None:
        return _classify_over_mesh(sequence_file, out_dir, bank, taxonomy,
                                   batch)
    from ..io.fasta import read_fasta
    from ..utils.observe import ProgressLog, vlog

    recs = list(read_fasta(sequence_file))
    read_ids = [h.split()[0] for h, _ in recs]
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


def _classify_over_mesh(sequence_file, out_dir, bank, taxonomy, batch):
    """classify_file over the bank's mesh. Spans ``phymm.parse`` (the
    rank's share read, its ids and codes), ``mesh.offsets`` (the shares'
    sizes), ``mesh.gather`` (the ids and the scores), ``phymm.score.fetch``
    (the whole matrix's download) and ``mesh.barrier`` besides the
    scoring's and the writers'."""
    from ..io import fasta_share
    from ..utils.observe import ProgressLog, vlog

    mesh = bank.mesh
    data, model = mesh.shape
    me = mesh.get_local_rank("data")
    enc = locale.getpreferredencoding(False)
    with observe.span("phymm.parse") as sp:
        ids, codes, offsets = fasta_share.read_share(sequence_file, me, data)
        id_text = "".join(r + "\n" for r in ids).encode(enc)
        sp.set(reads=len(ids))
    every = pmesh.exchange([len(ids), len(id_text)])  # a row a rank
    sizes = every[::model]  # a row a data coordinate
    total = int(sizes[:, 0].sum())
    vlog(1, f"[phymm] {len(bank.paths)} ICMs x {len(ids)} of {total} reads")
    progress = None
    if pmesh.is_output_process():
        base = os.path.basename(sequence_file).replace(".", "_")
        progress = ProgressLog(os.path.join(out_dir, f"{base}_progress.txt"),
                               total, every=50)
    block = bank.score_share(codes, offsets, batch=batch, progress=progress)
    m = len(bank.paths)
    read_ids, scores = [], block.new_zeros((0, m))
    if total:
        parts = pmesh.gather_bytes(id_text, every[:, 1])[::model]
        read_ids = b"".join(parts).decode(enc).split("\n")[:-1]
        scores = pmesh.gather_blocks(mesh, block, sizes[:, 0])[:, :m] \
            .contiguous()
    with observe.span("phymm.score.fetch"):
        host = scores.cpu().numpy()
    if progress is not None and total > progress.done:
        with observe.span("phymm.progress"):
            progress.advance(total - progress.done)
    raw = os.path.join(out_dir, raw_phymm_name(sequence_file))
    table = os.path.join(out_dir, results_name(sequence_file))
    if data > 1 and pmesh.one_host():
        first = int(sizes[:me, 0].sum())
        _write_shares(raw, table, bank.paths, taxonomy, mesh, sizes, id_text,
                      ids, scores, host[first:first + len(ids)], enc)
    elif pmesh.is_output_process():
        write_raw_phymm_output(raw, bank.paths, read_ids, host)
        write_results_table(table, read_ids, bank.paths, host, taxonomy)
    pmesh.barrier()
    return bank.paths, read_ids, host


def _write_shares(raw, table, icm_paths, taxonomy, mesh, sizes, id_text,
                  ids, scores, mine, enc):
    """This rank's share of the raw matrix and of the results table,
    written at its offsets. The ranks at model coordinate 0 write: the one
    at data coordinate i its reads' ids (``id_text``) and table lines
    (``mine``: their rows of the scores) and the DATA rows of its block of
    the ICMs over every read (``scores``, the whole matrix), the first of
    them the fixed lines as well; ``sizes`` holds each data coordinate's
    reads and id bytes. The rows' and lines' lengths are exchanged
    (``parallel.mesh.exchange``) by every rank. Spans ``phymm.raw_matrix``
    and ``phymm.results_table``, each with parts ``.text`` and ``.io``;
    counter ``raw_matrix_bytes`` (the bytes this rank wrote)."""
    data, model = mesh.shape
    me = mesh.get_local_rank("data")
    writer = mesh.get_local_rank("model") == 0
    m = len(icm_paths)
    rows = lines = b""
    if writer:
        lo, hi = m * me // data, m * (me + 1) // data
        with observe.span("phymm.raw_matrix", rows=hi - lo,
                          reads=scores.shape[0]) as sp, sp.part("text"):
            rows = _rows_text(scores[:, lo:hi])
        with observe.span("phymm.results_table", reads=len(ids)) as sp, \
                sp.part("text"):
            lines = "".join(_table_lines(ids, icm_paths, mine, taxonomy)) \
                .encode(enc)
    lens = pmesh.exchange([len(rows), len(lines)])[::model]
    if not writer:
        return
    head = "".join([_RAW_HEAD[0]] + [p + "\n" for p in icm_paths]
                   + [_RAW_HEAD[1]]).encode(enc)
    mid, tail, top = (x.encode(enc) for x in (_RAW_HEAD[2], _RAW_HEAD[3],
                                              _TABLE_HEAD))
    at_mid = len(head) + int(sizes[:, 1].sum())
    at_rows = at_mid + len(mid)
    at_tail = at_rows + int(lens[:, 0].sum())
    pieces = [(len(head) + int(sizes[:me, 1].sum()), id_text),
              (at_rows + int(lens[:me, 0].sum()), rows)]
    tpieces = [(len(top) + int(lens[:me, 1].sum()), lines)]
    if me == 0:
        pieces += [(0, head), (at_mid, mid), (at_tail, tail)]
        tpieces.append((0, top))
    with observe.span("phymm.raw_matrix") as sp, sp.part("io"):
        observe.count("raw_matrix_bytes",
                      _pwrite(raw, at_tail + len(tail), pieces))
    with observe.span("phymm.results_table") as sp, sp.part("io"):
        _pwrite(table, len(top) + int(lens[:, 1].sum()), tpieces)


def _pwrite(path, size, pieces) -> int:
    """Write each (offset, bytes) of ``pieces`` into ``path``, which is
    created when missing and made ``size`` bytes long (other ranks write
    the rest of it); returns the bytes written."""
    fd = os.open(path, os.O_WRONLY | os.O_CREAT, 0o666)
    try:
        os.ftruncate(fd, size)
        done = 0
        for off, piece in pieces:
            view = memoryview(piece)
            while view.nbytes:
                k = os.pwrite(fd, view, off)
                view, off, done = view[k:], off + k, done + k
        return done
    finally:
        os.close(fd)
