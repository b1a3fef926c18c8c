"""The port's command line against the JAX package's, on the CPU.

Every subcommand of ``glimmer_mg_tpu.cli.COMMANDS`` runs through both
``glimmer_mg_tpu.cli.main`` and ``glimmer_mg_torch.cli.main`` (the port's
device commands with ``--device cpu``) on the same synthetic inputs, each
in its own working directory: standard output, standard error and every
file written must be byte-equal. The only exception is g3-iterated's
stage-timing report on standard output, whose seconds are wall-clock
times; its other lines and all its files are compared. ``classify`` runs
the JAX package's TPU branch on the CPU (``jax.default_backend`` patched
to "tpu", the Pallas walk in interpret mode), whose 16-bit tables the
port's bank walk matches bitwise; the JAX package's exact f32 walk on the
CPU is only within length/512 of it. Also: ``glimmer-mg --num_procs 2``
parts concatenate to the single-process output, ``--device`` defaults to
cuda and is an error without a GPU, the mesh and multi-host flags without
a world of ranks or with half a multi-host spec stop with a parser error
that names the cause (tests/test_torch_mesh_cli.py runs them over ranks),
and ``glimmer-mg-pipeline --profile`` writes a trace.
"""

import functools
import io
import shutil
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from glimmer_mg_tpu import cli as jcli
from glimmer_mg_tpu.io.fasta import write_fasta
from glimmer_mg_tpu.ops import icm_pallas
from glimmer_mg_tpu.parallel import classify as jcl
from glimmer_mg_torch import cli as tcli
from glimmer_mg_torch.parallel import phymm as tphymm
from glimmer_mg_torch.pipeline import glimmer_mg_pipe as tpipe

from tests._torch_common import mg_db, one_torch_thread  # noqa: F401
from tests.test_pipeline_mg import _make_genome


def _main(main, argv, cwd, stdin=None):
    """(stdout, stderr) of ``main(argv)`` run in ``cwd`` with ``stdin``."""
    out, err = io.StringIO(), io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(cwd)
        mp.setattr(sys, "stdin", io.StringIO(
            (cwd / stdin).read_text() if stdin else ""))
        mp.setattr(sys, "stdout", out)
        mp.setattr(sys, "stderr", err)
        assert main(argv) == 0
    return out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def src(mg_db, one_torch_thread, tmp_path_factory):
    """The inputs, made once: a 33 kb genome, its long ORFs as coordinate
    lists, the genes they cover, an ICM trained on them, equal-length
    start windows and a fixed-length ICM, a glimmer3 .predict; the
    two-genome database with its 30 reads of 600 bp, their classes from
    the port's raw Phymm matrix (in ``raw/``), a quality file, and an
    empty ``cls/`` for classify's output."""
    root, icm_dir, reads, _truth = mg_db
    d = tmp_path_factory.mktemp("cli_src")
    rng = np.random.default_rng(3)
    write_fasta(d / "genome.fa", [("gen1 test", _make_genome(rng, 0.45, 40))],
                width=60)
    run = functools.partial(_main, jcli.main, cwd=d)
    run(["long-orfs", "genome.fa", "coords.txt", "-n", "-l"])
    lines = (d / "coords.txt").read_text().splitlines()
    (d / "mcoords.txt").write_text("".join(
        f"{t[0]} gen1 {t[1]} {t[2]}\n" for t in map(str.split, lines)))
    genes, _ = run(["extract", "genome.fa", "coords.txt"])
    (d / "genes.fa").write_text(genes)
    run(["build-icm", "model.icm", "--input", "genes.fa"])
    seqs = ["".join(rec.splitlines()[1:]) for rec in genes.split(">")[1:]]
    (d / "windows.fa").write_text("".join(f">w{k}\n{s[:18]}\n"
                                          for k, s in enumerate(seqs)))
    run(["build-fixed", "fixed.model"], stdin="windows.fa")
    run(["glimmer3", "genome.fa", "g3", "-m", "model.icm"])

    shutil.copytree(icm_dir, d / "genomeData")
    shutil.copy(root / "reads.fa", d / "reads.fa")
    (d / "raw").mkdir()
    (d / "cls").mkdir()
    tphymm.classify_file(str(d / "reads.fa"), str(d / "genomeData"),
                         out_dir=str(d / "raw"), device="cpu")
    classes, _top = tpipe.parse_phymm(
        str(d / "raw" / tphymm.raw_phymm_name("reads.fa")),
        tpipe.informative_genomes(str(d / "genomeData")), 3)
    (d / "classes.txt").write_text("".join(
        f"{rid}\t{' '.join(c)}\n" for rid, c in classes.items()))
    qrng = np.random.default_rng(4)
    (d / "reads.qual").write_text("".join(
        f">{h}\n{' '.join(str(q) for q in qrng.integers(5, 41, len(s)))}\n"
        for h, s in reads[::2]))
    return d


MG = ["glimmer-mg", "reads.fa"]
CASES = {
    "build-icm": (["build-icm", "out.icm", "--input", "genes.fa"], None),
    "glimmer3": (["glimmer3", "genome.fa", "run", "-m", "model.icm"], None),
    "glimmer-mg": (MG + ["mg", "-m", "model.icm"], None),
    "glimmer-mg-classes": (MG + ["mg", "-c", "classes.txt", "--genome_data",
                                 "genomeData"], None),
    "glimmer-mg-classes-subs-quality": (
        MG + ["mg", "-c", "classes.txt", "--genome_data", "genomeData", "-s",
              "-q", "reads.qual"], None),
    "long-orfs": (["long-orfs", "genome.fa", "lo.txt"], None),
    "extract": (["extract", "genome.fa", "coords.txt"], None),
    "train-features": (["train-features", "--predict", "g3.predict", "--seq",
                        "genome.fa"], None),
    "g3-iterated": (["g3-iterated", "genome.fa", "it"], None),
    "anomaly": (["anomaly", "genome.fa", "coords.txt"], None),
    "uncovered": (["uncovered", "genome.fa", "coords.txt"], None),
    "window-acgt": (["window-acgt", "1000", "500", "-p"], "genome.fa"),
    "start-codon-distrib": (["start-codon-distrib", "genome.fa",
                             "coords.txt"], None),
    "multi-extract": (["multi-extract", "genome.fa", "mcoords.txt"], None),
    "entropy-profile": (["entropy-profile"], "genes.fa"),
    "classify": (["classify", "reads.fa", "genomeData", "-o", "cls"], None),
    "glimmer-mg-pipeline": (["glimmer-mg-pipeline", "reads.fa", "genomeData",
                             "--iterate", "0", "--raw", "--workdir", "raw"],
                            None),
    "build-fixed": (["build-fixed", "out.model"], "windows.fa"),
    "score-fixed": (["score-fixed", "fixed.model", "-N"], "windows.fa"),
    "entropy-score": (["entropy-score", "genome.fa", "coords.txt"], None),
    "entropy-fasta": (["entropy-fasta"], "genes.fa"),
}
ON_DEVICE = ("glimmer-mg", "classify", "glimmer-mg-pipeline")


def _files(d):
    return {str(p.relative_to(d)): p.read_bytes()
            for p in sorted(d.rglob("*")) if p.is_file()}


def _untimed(text):
    """Standard output without the stage-timing report's lines."""
    lines = text.splitlines()
    if "stage timings:" in lines:
        lines = lines[:lines.index("stage timings:")]
    return lines


def test_every_command_has_a_case():
    assert set(tcli.COMMANDS) == set(jcli.COMMANDS)
    assert {argv[0] for argv, _stdin in CASES.values()} == set(jcli.COMMANDS)


@pytest.mark.parametrize("name", list(CASES))
def test_command_matches_jax(src, tmp_path, name):
    argv, stdin = CASES[name]
    dirs = {}
    for side in ("jax", "torch"):
        dirs[side] = tmp_path / side
        shutil.copytree(src, dirs[side])
    before = _files(dirs["jax"])
    with pytest.MonkeyPatch.context() as mp:
        if name == "classify":
            mp.setattr(jax, "default_backend", lambda: "tpu")
            mp.setattr(icm_pallas, "bank_score_reads_pallas",
                       functools.partial(icm_pallas.bank_score_reads_pallas,
                                         interpret=True, groups=1,
                                         e_block=128))
            mp.setattr(jcl, "classify_step_pallas",
                       jcl.classify_step_pallas.__wrapped__)
        want = _main(jcli.main, argv, dirs["jax"], stdin)
    extra = ["--device", "cpu"] if argv[0] in ON_DEVICE else []
    got = _main(tcli.main, argv + extra, dirs["torch"], stdin)
    if name == "g3-iterated":
        assert _untimed(got[0]) == _untimed(want[0])
        assert got[1] == want[1]
    else:
        assert got == want
    files = {side: _files(dirs[side]) for side in dirs}
    assert list(files["torch"]) == list(files["jax"])
    new = [k for k in files["jax"] if before.get(k) != files["jax"][k]]
    assert new or any(want), "the command wrote nothing"
    differ = [k for k in new if files["jax"][k] != files["torch"][k]]
    assert not differ, differ


def test_num_procs_parts_concatenate(src, tmp_path):
    d = tmp_path / "w"
    shutil.copytree(src, d)
    base = MG + ["mg", "-c", "classes.txt", "--genome_data", "genomeData",
                 "--device", "cpu"]
    _main(tcli.main, base, d)
    for k in range(2):
        _main(tcli.main, base + ["--num_procs", "2", "--proc_id", str(k)], d)
    parts = [(d / f"mg.predict.part{k}").read_text() for k in range(2)]
    assert parts[0] and parts[1]
    assert "".join(parts) == (d / "mg.predict").read_text()


def test_device_defaults_to_cuda(src, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: this checks a CPU-only machine")
    d = tmp_path / "w"
    shutil.copytree(src, d)
    for argv in (MG + ["mg", "-m", "model.icm"],
                 ["classify", "reads.fa", "genomeData"],
                 ["glimmer-mg-pipeline", "reads.fa", "genomeData"]):
        with pytest.raises(SystemExit) as exc:
            _main(tcli.main, argv, d)
        assert exc.value.code == 2
    assert _files(d) == _files(src)


@pytest.mark.parametrize("argv,message", [
    (["classify", "reads.fa", "genomeData", "--mesh", "2,1"],
     "needs a world of ranks"),
    (["classify", "reads.fa", "genomeData", "--coordinator", "localhost:1",
      "--num_procs", "2"], "must be given together"),
    (["glimmer-mg-pipeline", "reads.fa", "genomeData", "--mesh", "1,1"],
     "needs a world of ranks"),
], ids=["classify-mesh", "classify-multihost", "pipeline-mesh"])
def test_mesh_flags_stop_naming_a6(src, capsys, monkeypatch, argv, message):
    """The mesh flags are the port's own now: without a world of ranks
    (no launcher environment, no multi-host spec) or with half a
    multi-host spec they stop with a parser error that names the cause,
    not ROADMAP A6. tests/test_torch_mesh_cli.py runs them over ranks."""
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(SystemExit) as exc:
        tcli.main(argv + ["--device", "cpu"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert message in err and "A6" not in err


def test_pipeline_profile_writes_a_trace(src, tmp_path):
    d = tmp_path / "w"
    shutil.copytree(src, d)
    argv, _stdin = CASES["glimmer-mg-pipeline"]
    out, _err = _main(tcli.main, argv + ["--device", "cpu", "--engine",
                                         "native", "--profile", "prof"], d)
    assert out == "raw/reads.predict\n"
    traces = list((d / "prof").glob("*.pt.trace.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 1000
    assert b"traceEvents" in traces[0].read_bytes()


def test_module_entry_point(tmp_path):
    import subprocess

    proc = subprocess.run([sys.executable, "-m", "glimmer_mg_torch.cli"],
                          cwd=Path(__file__).resolve().parent.parent,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2
    assert proc.stderr.startswith("usage: glimmer_mg_torch <build-icm|")
