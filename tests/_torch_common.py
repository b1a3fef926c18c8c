"""Shared inputs for the PyTorch port's parity tests (tests/test_torch_*.py).

Everything is made from numpy seeds: two synthetic genomes trained into a
genomeData directory with ``train_all`` (the JAX package's own fixture
pattern), read sets (random, overlap-dense, long; for the error modes,
genes with planted stop codons and 454-like homopolymer indels), quality
maps, and the helpers that run the JAX package and compare outputs.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import pytest


@pytest.fixture(scope="module")
def one_torch_thread():
    """torch on one thread for a module's tests, restored after: the
    test suite runs several worker processes on the machine's cores, and
    torch's threads on large tensors then mostly wait for each other."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trained_models():
    """A two-genome model database (GC 0.38 / 0.58) and its class names."""
    from glimmer_mg_tpu.io.genome_data import GenomeData
    from glimmer_mg_tpu.pipeline import train_all

    rng = np.random.default_rng(5)
    root = tempfile.mkdtemp(prefix="torch_db_")
    genomes = {}
    for gi, gc in ((0, 0.38), (1, 0.58)):
        p = [(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2]

        def gene(ncod):
            cs = []
            while len(cs) < ncod:
                c = "".join(rng.choice(list("ACGT"), 3, p=p))
                if c not in ("TAA", "TAG", "TGA"):
                    cs.append(c)
            return "ATG" + "".join(cs) + rng.choice(["TAA", "TAG", "TGA"])

        parts = []
        for _ in range(60):
            parts.append(
                "".join(rng.choice(list("ACGT"), int(rng.integers(40, 200)),
                                   p=p)))
            g = gene(int(rng.integers(80, 300)))
            if rng.random() < 0.5:
                g = g[::-1].translate(str.maketrans("ACGT", "TGCA"))
            parts.append(g)
        genomes[f"s{gi}|chr"] = "".join(parts)
    train_all.train_all(genomes, os.path.join(root, "genomeData"))
    gd = GenomeData(os.path.join(root, "genomeData"))
    return gd, list(genomes)


def mg_genomes_and_reads():
    """The JAX package's pipeline fixture recipe (tests/test_pipeline_mg.py):
    two genomes (GC 0.33 / 0.62) and 30 reads of 600 bp, alternating.
    Returns (genomes, reads, truth)."""
    from tests.test_pipeline_mg import _make_genome

    rng = np.random.default_rng(11)
    genomes = {"alpha|chrA": _make_genome(rng, 0.33),
               "beta|chrB": _make_genome(rng, 0.62)}
    reads, truth = [], []
    keys = list(genomes)
    for i in range(30):
        cls = keys[i % 2]
        start = int(rng.integers(0, len(genomes[cls]) - 600))
        reads.append((f"read{i}", genomes[cls][start:start + 600]))
        truth.append(cls.split("|")[0])
    return genomes, reads, truth


@pytest.fixture(scope="module")
def mg_db(tmp_path_factory):
    """``mg_genomes_and_reads`` trained into a database with double ICMs,
    the reads written to ``reads.fa``."""
    from glimmer_mg_tpu.io.fasta import write_fasta
    from glimmer_mg_tpu.pipeline import train_all

    root = tmp_path_factory.mktemp("torch_mgdb")
    icm_dir = root / "genomeData"
    genomes, reads, truth = mg_genomes_and_reads()
    train_all.train_all(genomes, str(icm_dir), min_icm_bp=2000)
    train_all.double_icms(str(icm_dir))
    write_fasta(root / "reads.fa", reads, width=60)
    return root, icm_dir, reads, truth


def _gene_like(rng, ncod, gc):
    p = [(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2]
    cs = []
    while len(cs) < ncod:
        c = "".join(rng.choice(list("acgt"), 3, p=p))
        if c not in ("taa", "tag", "tga"):
            cs.append(c)
    return "atg" + "".join(cs) + str(rng.choice(["taa", "tag", "tga"]))


# every byte class the encoder meets: IUPAC codes, n, gaps, digits, a
# latin-1 letter past ASCII
ODD = "rysWMKbdhvNn*-.x9\xe9 "


def mixed_reads(seed, n, longest=150):
    """``n`` reads of at most ``longest`` bases: lower-, upper- and
    mixed-case genes, some with IUPAC codes and bytes outside the alphabet,
    and an empty one."""
    rng = np.random.default_rng(seed)
    reads = []
    for i in range(n):
        s = _gene_like(rng, int(rng.integers(1, (longest - 6) // 3 + 1)), 0.5)
        kind = i % 4
        if kind == 1:
            s = s.upper()
        elif kind == 2:
            s = "".join(c.upper() if rng.random() < 0.5 else c for c in s)
        elif kind == 3:
            at = rng.integers(0, len(s), 4)
            s = "".join(ODD[rng.integers(len(ODD))] if j in at else c
                        for j, c in enumerate(s))
        reads.append(s)
    if n > 2:
        reads[n // 2] = ""
    return reads


def former_score_reads(bank, seqs, batch, use_kernel=True):
    """``PhymmBank.score_reads`` as it was before slabs: ``pad_reads`` a
    batch, its upload, then the walk through the module's step."""
    import torch

    from glimmer_mg_torch.parallel import classify

    out = np.zeros((len(seqs), len(bank.paths)), dtype=np.float32)
    length = max((len(s) for s in seqs), default=0)
    length = max(3, length + (-length) % 3)
    for lo in range(0, len(seqs), batch):
        chunk = seqs[lo:lo + batch]
        reads, lengths = (torch.from_numpy(a).to(bank.device) for a in
                          classify.pad_reads(chunk, length=length))
        if use_kernel:
            scores, _ = classify.classify_step_kernel(
                *bank.tables, reads, lengths, bank.model_len, bank.depth)
        else:
            scores, _ = classify.classify_step(
                *bank.exact_tables(), reads, lengths, bank.model_len,
                bank.depth)
        out[lo:lo + len(chunk)] = scores.cpu().numpy()
    return out


def random_reads(seed, count, lo=30, hi=700):
    """Random reads of varied length and GC, degenerate tiny ones included."""
    rng = np.random.default_rng(seed)
    reads = []
    for i in range(count):
        n = int(rng.integers(lo, hi))
        gc = float(rng.uniform(0.3, 0.7))
        p = [(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2]
        reads.append((f"fz{i}", "".join(rng.choice(list("acgt"), n, p=p))))
    return reads


def overlap_dense_reads(seed, count, length=500):
    """Tightly packed, overlapping gene-like segments on both strands."""
    rng = np.random.default_rng(seed)
    reads = []
    for i in range(count):
        gc = (0.38, 0.58)[i % 2]
        parts = []
        total = 0
        while total < length - 50:
            g = _gene_like(rng, int(rng.integers(30, 80)), gc)
            if rng.random() < 0.5:
                g = g[::-1].translate(str.maketrans("acgt", "tgca"))
            ov = int(rng.integers(0, 45))
            if parts and ov:
                joined = "".join(parts)
                parts = [joined[: max(0, len(joined) - ov)]]
            parts.append(g)
            total = sum(len(p) for p in parts)
        reads.append((f"ov{i}", "".join(parts)[:length]))
    return reads


def long_reads(seed, count, lo=1450, hi=2100):
    """Gene-dense reads longer than 1.4 kb."""
    rng = np.random.default_rng(seed)
    reads = []
    for i in range(count):
        gc = (0.38, 0.58)[i % 2]
        parts = []
        total = 0
        target = int(rng.integers(lo, hi))
        while total < target:
            parts.append("".join(
                rng.choice(list("acgt"), int(rng.integers(20, 80)))))
            g = _gene_like(rng, int(rng.integers(40, 150)), gc)
            if rng.random() < 0.5:
                g = g[::-1].translate(str.maketrans("acgt", "tgca"))
            parts.append(g)
            total = sum(len(x) for x in parts)
        reads.append((f"lr{i}", "".join(parts)[:target]))
    return reads


def start_rich_reads(seed, count, n=700):
    """Reads dense in start codons, so that the error-free frontend finds
    more than MAX_EVENTS candidates in some: runs of atg (a forward start
    every codon, and cat, the reverse start, in the complement) between
    random stretches. Every fifth read is a tiny one and every fifth one
    holds stops only (no ORF)."""
    rng = np.random.default_rng(seed)
    reads = []
    for i in range(count):
        if i % 5 == 3:
            s = "acgtt"
        elif i % 5 == 4:
            s = "taa" * (n // 3)
        else:
            s = ""
            while len(s) < n:
                s += "atg" * int(rng.integers(20, 120))
                s += "".join(rng.choice(list("acgt"),
                                        int(rng.integers(0, 40))))
            s = s[:n]
        reads.append((f"sr{i}", s))
    return reads


STOPS_FWD = ("taa", "tag", "tga")


def planted_stop_reads(seed, count, lo=400, hi=510):
    """Gene-dense reads on both strands, each gene (150-300 codons) with
    one stop codon planted in its own frame, in the middle 40% of the
    gene: a substitution that a sub-extended gene can read through."""
    rng = np.random.default_rng(seed)
    comp = str.maketrans("acgt", "tgca")
    reads = []
    for i in range(count):
        gc = (0.38, 0.58)[i % 2]
        n = int(rng.integers(lo, hi + 1))
        parts, total = [], 0
        while total < n:
            parts.append("".join(rng.choice(list("acgt"),
                                            int(rng.integers(5, 30)))))
            ncod = int(rng.integers(150, 300))
            g = list(_gene_like(rng, ncod, gc))
            k = int(rng.integers(int(ncod * 0.3), int(ncod * 0.7)))
            g[3 * k:3 * k + 3] = STOPS_FWD[int(rng.integers(3))]
            g = "".join(g)
            if rng.random() < 0.5:
                g = g[::-1].translate(comp)
            parts.append(g)
            total = sum(len(p) for p in parts)
        reads.append((f"ps{i}", "".join(parts)[:n]))
    return reads


def quality_map(reads, seed, every=3):
    """Per-base qualities in [1, 87] for two reads in ``every`` (read
    index % every != every - 1). The first read has 254 (the ceiling of
    the device upload, p = 1.0 in f64) at every third base: a codon holds
    one such base, so no stop penalty meets p_stop = 1, at which the host
    engine's log raises."""
    rng = np.random.default_rng(seed)
    quals = {}
    for i, (h, s) in enumerate(reads):
        if i % every != every - 1:
            quals[h] = [int(q) for q in rng.integers(1, 88, len(s))]
    first, s0 = reads[0]
    quals[first] = [254 if k % 3 == 0 else int(q)
                    for k, q in enumerate(rng.integers(1, 88, len(s0)))]
    return quals


def homopolymer_indel_reads(seed, count, rate=0.003, lo=250, hi=500):
    """454-like reads: gene-dense sequence with homopolymer indels, a base
    inside a run dropped or repeated; runs hold about a quarter of the
    bases, so they take 4 x ``rate`` each and the reads ``rate`` per
    base."""
    rng = np.random.default_rng(seed)
    reads = []
    for i, (_h, s) in enumerate(overlap_dense_reads(seed + 2, count,
                                                    length=hi + 20)):
        out = []
        for k, ch in enumerate(s):
            r = rng.random() if k and s[k - 1] == ch else 1.0
            if r < 2 * rate:
                continue
            out.append(ch)
            if r < 4 * rate:
                out.append(ch)
        n = int(rng.integers(lo, hi + 1))
        reads.append((f"hp{i}", "".join(out)[:n]))
    return reads


def class_map(reads, classes, pair_every=0):
    """Each read classified to one class (alternating); with pair_every=k,
    every k-th read also to the other class."""
    out = {}
    for i, (h, _s) in enumerate(reads):
        cl = [classes[i % 2]]
        if pair_every and i % pair_every == 0:
            cl.append(classes[(i + 1) % 2])
        out[h.split()[0]] = cl
    return out


def batch_inputs(reads, cmap, gd, l_pad, b_pad):
    """A padded device batch in input order: (models_list, reads (b_pad,
    l_pad) i32, lengths, groups), with per-read classes-mode Models."""
    from glimmer_mg_tpu.models import dna
    from glimmer_mg_torch.engine import glimmer_mg as teng

    cache, ids, models_list = {}, {}, []
    out_reads = np.zeros((b_pad, l_pad), np.int32)
    lengths = np.zeros(b_pad, np.int32)
    groups = np.zeros(b_pad, np.int32)
    for r, (h, s) in enumerate(reads):
        key = (tuple(cmap[h]), len(s))
        m = cache.get(key)
        if m is None:
            m = cache[key] = teng.classes_models(
                list(key[0]), len(s), gd, parsed=None, user_icm=None,
                user_gc=None, user_rbs_pwm=None, user_stop_codons=None,
                fudge_f32=np.float32(1.0), min_gene_len=75,
                max_olap_bases=50, circular=False, icm_cache={})
        if id(m) not in ids:
            ids[id(m)] = len(models_list)
            models_list.append(m)
        out_reads[r, :len(s)] = dna.encode(s)
        lengths[r] = len(s)
        groups[r] = ids[id(m)]
    return models_list, out_reads, lengths, groups


def f32_ulps(a, b):
    """Elementwise distance of two f32 arrays of one sign in units in the
    last place."""
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def coords(genes):
    return [(g.id, g.start, g.stop, g.frame) for g in genes]


def records(out):
    """(header, [(id, start, stop, frame, ((pos, type), ...)), ...]) of a
    prediction run's output."""
    return [(h, [(g.id, g.start, g.stop, g.frame,
                  tuple((e.pos, e.type) for e in g.errors)) for g in gs])
            for h, gs in out]


def sub_genes(out):
    """Genes of a run's output that carry an error record."""
    return sum(1 for _h, gs in out for g in gs if g.errors)


def jax_run(fn, *args, device=False, f64=True, **kw):
    """A JAX package prediction run: its exact host engine
    (GLIMMER_MG_TPU_DEVICE_DP=0, GLIMMER_MG_TPU_NATIVE=0,
    device_precompute=False) or, with ``device``, its device path. The
    f32 carry (``f64=False``) is the device path traced without x64,
    which tests/conftest.py enables globally. The variables are restored
    after the run: the port's native engine reads the same switch."""
    import jax

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GLIMMER_MG_TPU_NATIVE", "0")
        mp.setenv("GLIMMER_MG_TPU_DEVICE_DP", "1" if device else "0")
        if not f64:
            mp.setenv("GLIMMER_MG_TPU_DEVICE_DP_F32", "1")
        with jax.enable_x64(f64):
            return list(fn(*args, device_precompute=False, **kw))


# wrapper arguments with one out of range (bad_bank_walk_call cases)
BAD = ["depth_too_deep", "length_not_multiple_of_3", "length_past_L",
       "length_negative", "prob_rows_short", "model_len_too_long"]


def bad_bank_walk_call(t, case):
    """bank_score_reads_kernel arguments (list, kwargs) with one out of
    range; ``t`` = [level_mip, probs_pk, reads, lengths]."""
    t, kw = list(t), {"model_len": 12, "depth": 7}
    if case == "depth_too_deep":
        kw["depth"] = 8
    elif case == "length_not_multiple_of_3":
        t[2] = t[2][:, :-1].contiguous()
        t[3] = t[3].clamp(max=t[2].shape[1])
    elif case == "length_past_L":
        t[3] = t[3].clone()
        t[3][1] = t[2].shape[1] + 1
    elif case == "length_negative":
        t[3] = t[3].clone()
        t[3][0] = -1
    elif case == "prob_rows_short":
        t[1] = t[1][:, :, :-2].contiguous()
    else:
        kw["model_len"] = 17
    return t, kw


def small_sample_run(root, seed=11):
    """A small stand-in for the sample-run (``bench_db.build_sample_run``):
    a 60-gene genome and 30 reads from two 10-gene strains. Returns
    (root, strains)."""
    from glimmer_mg_torch import bench_db

    rng = np.random.default_rng(seed + 100)
    strains = {"sa|chr": bench_db.make_genome(rng, 0.4, n_genes=10),
               "sb|chr": bench_db.make_genome(rng, 0.6, n_genes=10)}
    return (bench_db.build_sample_run(root, strains, seed=seed, n_genes=60,
                                      n_reads=30), strains)


def redirect_jax_sample_run(monkeypatch, root):
    """Point the JAX package's fixed sample-run location (the one that
    tests/oracle.py's reference root holds) at ``root``, for one test: the
    JAX functions read it with ``io.fasta.read_fasta`` and
    ``Path.read_text``."""
    import pathlib

    from glimmer_mg_tpu.io import fasta

    from tests import oracle

    fixed = str(oracle.REF_SRC.parent / "sample-run")

    def moved(path):
        p = str(path)
        return str(root) + p[len(fixed):] if p.startswith(fixed) else p

    read_fasta, read_text = fasta.read_fasta, pathlib.Path.read_text
    monkeypatch.setattr(fasta, "read_fasta",
                        lambda path, *a, **k: read_fasta(moved(path), *a, **k))
    monkeypatch.setattr(pathlib.Path, "read_text",
                        lambda self, *a, **k: read_text(
                            pathlib.Path(moved(self)), *a, **k))
