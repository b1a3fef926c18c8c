"""The port's own host layers against the JAX package's.

``glimmer_mg_torch`` keeps copies of the JAX package's JAX-free host
modules and builds its own native engine into ``build/``. Here the port's
``train_all`` and ``double_icms`` (long-orfs bootstrap, ICM training, the
native glimmer3 pass, feature files, RBS motif) write the same files, byte
for byte, as the JAX package's on a small synthetic two-genome database,
and every module of the port imports with ``glimmer_mg_tpu`` and ``jax``
blocked, and its command line then predicts reads on the native route.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np

from glimmer_mg_tpu.pipeline import train_all as jtrain
from glimmer_mg_torch import native
from glimmer_mg_torch.pipeline import train_all as ttrain

from tests.test_pipeline_mg import _make_genome

REPO = Path(__file__).resolve().parent.parent


def _files(root: Path) -> dict[str, bytes]:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_train_all_writes_the_jax_packages_files(tmp_path):
    rng = np.random.default_rng(23)
    genomes = {"alpha|chrA": _make_genome(rng, 0.36, n_genes=40),
               "beta|chrB": _make_genome(rng, 0.6, n_genes=40)}
    out = {}
    for name, mod in (("jax", jtrain), ("torch", ttrain)):
        icm_dir = tmp_path / name / "genomeData"
        mod.train_all(genomes, str(icm_dir), min_icm_bp=2000)
        mod.double_icms(str(icm_dir))
        out[name] = _files(icm_dir)
    assert list(out["torch"]) == list(out["jax"])
    suffixes = {os.path.basename(k).split(".", 1)[-1] for k in out["jax"]}
    assert {"icm", "gicm", "motif", "gene.fasta"} <= suffixes, suffixes
    differ = [k for k in out["jax"] if out["jax"][k] != out["torch"][k]]
    assert not differ, differ
    # the port's native engine, built into build/ at the repository root
    assert Path(native._SO).parent == REPO / "build"
    assert native.available()


def test_every_module_imports_without_the_jax_package():
    script = textwrap.dedent("""
        import importlib, pkgutil, sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "glimmer_mg_tpu"):
                    raise ImportError(name + " is blocked")
                return None

        sys.meta_path.insert(0, Block())
        import glimmer_mg_torch
        names = [m.name for m in pkgutil.walk_packages(
            glimmer_mg_torch.__path__, "glimmer_mg_torch.")]
        for name in names:
            importlib.import_module(name)

        import os, tempfile
        import numpy as np
        from glimmer_mg_torch import cli
        from glimmer_mg_torch.engine import glimmer_mg as tmg
        from glimmer_mg_torch.io.fasta import write_fasta
        from glimmer_mg_torch.models import dna, icm, icm_train
        from tests._torch_common import _gene_like, overlap_dense_reads

        rng = np.random.default_rng(1)
        train = [dna.encode(_gene_like(rng, 150, 0.5)) for _ in range(20)]
        d = tempfile.mkdtemp()
        icm.write_icm(icm_train.train_icm(train, model_len=12, depth=5),
                      os.path.join(d, "m.icm"))
        write_fasta(os.path.join(d, "r.fa"), overlap_dense_reads(3, 6))
        assert cli.main(["glimmer-mg", os.path.join(d, "r.fa"),
                         os.path.join(d, "out"), "-m", os.path.join(d, "m.icm"),
                         "--device", "cpu", "--engine", "native"]) == 0
        assert tmg.counters["native_reads"] == 6, tmg.counters
        assert open(os.path.join(d, "out.predict")).read().count(">") == 6
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "glimmer_mg_tpu")]
        assert not bad, bad
        print("OK", len(names))
    """)
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("OK")
    assert int(proc.stdout.split()[1]) >= 30
