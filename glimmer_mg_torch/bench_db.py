"""Synthetic benchmark fixtures: genomes, a Phymm-style genomeData DB, reads.

Counterpart of ``glimmer_mg_tpu.bench_db``, verbatim apart from import
lines, with two differences. ``bench_reads_and_classes`` reads its reads
from ``<sample_root>/glimmer-mg/seqs.fa``, where the JAX function reads the
reference's sample-run at a fixed location. ``build_sample_run`` is new: it
writes a seeded SYNTHETIC stand-in for the sample-run files that the bench
and ``pipeline.accuracy`` read, in the reference's own layout, so that they
run where the reference's sample-run is absent. The stand-in's files are
not the reference's: its genome is a ``make_genome`` draw at H. pylori's GC
and size, its gene calls are the port's own g3-iterated bootstrap on that
genome, and its reads are sampled from the bench DB's synthetic strains.

The reference's Phymm DB (~50 GB of trained reference-genome models,
docs/notes.tex:80-83) is not shipped, so throughput benchmarks and
classification-mode comparisons run against a deterministic synthetic DB:
gene-dense random genomes self-trained with this framework's own pipeline
(long-orfs -> extract -> build-icm -r -> glimmer3 -> train_features), the
exact bootstrap the reference uses for novel genomes (g3-iterated.py).
The resulting .genomeData tree is consumed identically by our GenomeData
loader and by a reference glimmer-mg binary compiled with ICM_dir pointing
at it (the installer patches that constant, install_glimmer.py:122-125).
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

STOPS = ("TAA", "TAG", "TGA")


def make_genome(rng, gc: float, n_genes: int = 50) -> str:
    """A random genome with dense unambiguous genes at the given GC."""
    p = [(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2]

    def gene(n_codons):
        codons = []
        while len(codons) < n_codons:
            c = "".join(rng.choice(list("ACGT"), 3, p=p))
            if c not in STOPS:
                codons.append(c)
        return "ATG" + "".join(codons) + rng.choice(list(STOPS))

    parts = []
    for _ in range(n_genes):
        parts.append(
            "".join(rng.choice(list("ACGT"), int(rng.integers(50, 300)), p=p))
        )
        g = gene(int(rng.integers(100, 400)))
        if rng.random() < 0.4:
            g = g[::-1].translate(str.maketrans("ACGT", "TGCA"))
        parts.append(g)
    return "".join(parts)


def build_bench_db(root, n_strains: int = 8, seed: int = 7, n_genes: int = 50):
    """Build (or reuse) a genomeData tree of self-trained synthetic genomes.

    Returns (class_names, genomes dict). Layout matches the Phymm DB the
    reference expects: genomeData/<strain>/<nc>.{gicm,lengths.*,starts,...}.
    """
    from .engine import glimmer3 as g3
    from .models import dna, icm_train
    from .pipeline import extract as ex, long_orfs as lo, train_features as tf

    root = Path(root)
    gd = root / "genomeData"
    gd.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    gcs = np.linspace(0.35, 0.65, n_strains)
    genomes = {}
    classes = []
    for gi in range(n_strains):
        cls = f"strain{gi}|chr"
        classes.append(cls)
        genomes[cls] = make_genome(rng, float(gcs[gi]), n_genes=n_genes)

    for cls, seq in genomes.items():
        strain, nc = cls.split("|")
        d = gd / strain
        d.mkdir(exist_ok=True)
        if (d / f"{nc}.gicm").exists():
            continue
        lines, _ = lo.run_long_orfs(seq, entropy_cutoff=1.15)
        train_recs = list(ex.extract(seq, "\n".join(lines), skip_stop=True))
        strings = icm_train.prepare_training_strings(
            [s for _, s in train_recs], reverse=True
        )
        m = icm_train.train_icm([dna.encode(s) for s in strings])
        res = list(g3.run_glimmer3([(nc, seq)], m, logodds_fudge=-12))
        tf.train_genome_data(g3.format_predict(res), {nc: seq}, str(d / nc))
    return classes, genomes


def bench_reads_and_classes(classes, seed: int = 3, top_k: int = 2, *,
                            sample_root):
    """The 999 sample-run reads with deterministic synthetic class calls.

    Each read gets ``top_k`` classes drawn round-robin (the real pipeline
    assigns the top-3 Phymm hits; parse_phymm, glimmer-mg.py:536-605).
    ``sample_root`` is a sample-run directory: the reference's, or the
    stand-in of :func:`build_sample_run`.
    Returns (reads [(header, seq)], class_lines [str]).
    """
    from .io.fasta import read_fasta

    recs = list(
        read_fasta(os.path.join(sample_root, "glimmer-mg", "seqs.fa"))
    )
    rng = np.random.default_rng(seed)
    class_lines = []
    n = len(classes)
    for i, (h, _s) in enumerate(recs):
        k0 = int(rng.integers(0, n))
        picks = [classes[(k0 + j) % n] for j in range(top_k)]
        class_lines.append("%s\t%s" % (h.split()[0], " ".join(picks)))
    return recs, class_lines


def tile_reads(reads, class_lines, target: int):
    """Tile a read set (with its class calls) to >= ``target`` reads.

    Copies get distinct header prefixes (``<id>_t<k>``) so the per-read
    class map stays 1:1; model mixing/caching behaves as in a real run at
    that scale (many reads per class pair). Mirrors probing the reference's
    500k-read chunk granularity (glimmer-mg.cc:130-131) without shipping a
    500k-read fixture.
    """
    out_reads = list(reads)
    out_lines = list(class_lines)
    k = 1
    while len(out_reads) < target:
        for (h, s), line in zip(reads, class_lines):
            toks = line.split("\t")
            hh = h.split()
            new_id = f"{hh[0]}_t{k}"
            out_reads.append((new_id, s))
            out_lines.append("%s\t%s" % (new_id, toks[1]))
            if len(out_reads) >= target:
                break
        k += 1
    return out_reads, out_lines


# The stand-in's genome: H. pylori 26695's GC and gene count, about its
# 1.67 Mb (SURVEY.md:426; the reference's golden run2.predict has 1,802
# genes); its reads: 999 of 500 bp, as the reference's sample metagenome.
SAMPLE_GC = 0.39
SAMPLE_GENES = 1800
SAMPLE_READS = 999
SAMPLE_READ_LEN = 500
SAMPLE_HEADER = "NC_000915_synthetic seeded stand-in for H. pylori 26695"


def build_sample_run(root, strains: dict[str, str], *, seed: int = 11,
                     n_genes: int = SAMPLE_GENES, n_reads: int = SAMPLE_READS,
                     read_len: int = SAMPLE_READ_LEN) -> str:
    """Write (or reuse) a synthetic stand-in for the reference's sample-run
    under ``root``, in its layout; returns ``root``.

      * ``glimmer3/NC_000915.fna``: one ``make_genome`` genome of
        ``n_genes`` genes at GC 0.39, under a header that says it is
        synthetic;
      * ``glimmer3/results/NC_000915.{icm,run1.predict,run2.predict}`` and
        the rest of g3-iterated's artifact set: ``run_g3_iterated`` on that
        genome, the bootstrap that made the reference's files;
      * ``glimmer-mg/seqs.fa``: ``n_reads`` reads of ``read_len`` bp,
        round-robin over the genomes of ``strains`` (``build_bench_db``'s),
        each from a uniform start on either strand, as
        ``pipeline.accuracy.simulate_reads`` samples, with a unique id.

    Every draw comes from one numpy generator seeded with ``seed``. The
    marker ``.sample_run_done``, written last, makes a half-built ``root``
    build again.
    """
    from .io.fasta import write_fasta
    from .models import dna
    from .pipeline.g3_iterated import run_g3_iterated

    root = str(root)
    done = os.path.join(root, ".sample_run_done")
    if os.path.exists(done):
        return root
    g3_dir = os.path.join(root, "glimmer3")
    os.makedirs(os.path.join(g3_dir, "results"), exist_ok=True)
    os.makedirs(os.path.join(root, "glimmer-mg"), exist_ok=True)

    rng = np.random.default_rng(seed)
    genome = make_genome(rng, SAMPLE_GC, n_genes=n_genes)
    fna = os.path.join(g3_dir, "NC_000915.fna")
    write_fasta(fna, [(SAMPLE_HEADER, genome)])
    run_g3_iterated(fna, os.path.join(g3_dir, "results", "NC_000915"),
                    verbose=False)

    names = list(strains)
    reads = []
    for i in range(n_reads):
        name = names[i % len(names)]
        g = strains[name]
        gstart = int(rng.integers(1, len(g) - read_len + 1))
        gend = gstart + read_len - 1
        strand = 1 if rng.random() < 0.5 else -1
        frag = g[gstart - 1 : gend]
        if strand < 0:
            frag = dna.reverse_complement_str(frag)
        sign = "+" if strand > 0 else "-"
        reads.append((f"read{i} {name}:{gstart}-{gend}:{sign}", frag))
    write_fasta(os.path.join(root, "glimmer-mg", "seqs.fa"), reads)
    with open(done, "w") as fh:
        fh.write("ok\n")
    return root


def build_reference_classes_binary(db_root) -> str:
    """Compile the reference glimmer-mg with ICM_dir patched to the bench DB
    (the reference hard-codes it; install_glimmer.py:122-125). Returns the
    binary path, building the shared oracle objects on first use."""
    import re
    import subprocess
    import sys

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from tests import oracle

    oracle.ensure_built()
    bdir = oracle.BUILD
    tag = Path(db_root).name.replace("-", "_")
    src = (bdir / "Glimmer/glimmer-mg.cc").read_text()
    src = re.sub(
        r'static string ICM_dir = ".*";',
        f'static string ICM_dir = "{db_root}/genomeData";',
        src,
    )
    cc = bdir / f"Glimmer/glimmer-mg-{tag}.cc"
    cc.write_text(src)
    binary = oracle.BIN / f"glimmer-mg-{tag}"
    if not binary.exists():
        subprocess.run(
            oracle._CXX + oracle._INC
            + [str(cc)]
            + [str(oracle.OBJ / o) for o in
               ("glimmer_base.o", "icm.o", "delcher.o", "gene.o",
                "kelley.o", "fasta.o")]
            + ["-o", str(binary)],
            check=True,
        )
    return str(binary)
