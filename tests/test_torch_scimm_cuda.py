"""Scimm clustering and pipeline stages 4-5 of the port on the card, held
to the same port code on the CPU.

Needs an NVIDIA GPU with nvcc (marker ``cuda``); skipped elsewhere. Run on
a GPU machine with ``python -m pytest tests/test_torch_scimm_cuda.py -q``.
The inputs are made by the port alone (its ``train_all`` on two seeded
genomes):

* ``train_icm_bank`` on the card against the CPU, 3 models at depth 7 on
  seeded reads: ``ops.icm_train_check.tie_nodes`` passes (equal counts,
  mutual information within 4 x 2^-23 x the sum of its terms' magnitudes,
  ``mip`` equal except at a printed near-tie, logged probs within 4 f32
  ulps relative);
* the device EM on the card (the bank-walk kernel launched once per EM
  iteration) against the device EM on the CPU (its twin): equal
  assignments;
* ``run_pipeline(iterate=1, cluster_device=True)`` on the card against
  the CPU: every ``*.cluster-<k>.predict`` and the final ``.predict``
  byte-equal (one process: the arbitration's output order follows the
  process's string hashes), both kernels launched.
"""

import numpy as np
import pytest
import torch

from glimmer_mg_torch.ops import icm_cuda, icm_train_check, icm_train_device
from glimmer_mg_torch.parallel.classify import pad_reads

from tests._torch_common import _gene_like

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


def _genome(rng, gc, n_genes=60):
    p = [(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2]
    comp = str.maketrans("acgt", "tgca")
    parts = []
    for _ in range(n_genes):
        parts.append("".join(rng.choice(list("acgt"),
                                        int(rng.integers(50, 250)), p=p)))
        g = _gene_like(rng, int(rng.integers(100, 350)), gc)
        parts.append(g[::-1].translate(comp) if rng.random() < 0.5 else g)
    return "".join(parts).upper()


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    from glimmer_mg_torch.host import write_fasta
    from glimmer_mg_torch.pipeline import train_all

    rng = np.random.default_rng(21)
    genomes = {"alpha|chrA": _genome(rng, 0.33),
               "beta|chrB": _genome(rng, 0.62)}
    root = tmp_path_factory.mktemp("scimm_cuda")
    icm_dir = root / "genomeData"
    train_all.train_all(genomes, str(icm_dir), min_icm_bp=2000)
    train_all.double_icms(str(icm_dir))
    reads, truth = [], []
    for i in range(40):
        name = list(genomes)[i % 2]
        st = int(rng.integers(0, len(genomes[name]) - 600))
        reads.append((f"read{i}", genomes[name][st:st + 600]))
        truth.append(i % 2)
    write_fasta(root / "reads.fa", reads, width=60)
    return root, icm_dir, reads, np.array(truth, np.int32)


def test_trainer_on_card_matches_cpu(cuda, db):
    _root, _icm_dir, reads, _truth = db
    seqs, lengths = pad_reads([s.lower() for _h, s in reads], length=600)
    assign = np.zeros((len(reads), 3), np.float32)
    assign[np.arange(len(reads)), np.arange(len(reads)) % 3] = 1.0
    out = []
    for dev in ("cpu", cuda):
        rec = {}
        mip, probs = icm_train_device.train_icm_bank(
            *(torch.from_numpy(x).to(dev) for x in (seqs, lengths, assign)),
            n_models=3, depth=7, record=rec)
        assert mip.device.type == torch.device(dev).type
        out += [mip, probs, rec]
    ties, worst = icm_train_check.tie_nodes(*out)
    print(f"largest MI difference: {worst:.3f} x 2^-23 x its terms' "
          "magnitude")
    for t in ties:
        print("near-tie (cpu, card):", t)


def test_device_em_on_card_matches_cpu(cuda, db):
    from glimmer_mg_torch.pipeline import scimm

    _root, _icm_dir, reads, truth = db
    seqs = [s for _h, s in reads]
    init = truth.copy()
    init[::3] = 1 - init[::3]
    a_cpu, _icms, s_cpu = scimm.scimm_cluster(seqs, init, 2, use_device=True,
                                              device="cpu")
    icm_cuda.reset_launches()
    a_gpu, _icms, s_gpu = scimm.scimm_cluster(seqs, init, 2, device=cuda)
    assert icm_cuda.bank_walk_launches > 0
    assert np.array_equal(a_gpu, a_cpu)
    assert not np.array_equal(a_gpu, init)
    assert s_gpu.shape == s_cpu.shape == (len(seqs), 2)


def test_pipeline_iterate_on_card_matches_cpu(cuda, db):
    from glimmer_mg_torch.pipeline import glimmer_mg_pipe as pipe

    root, icm_dir, _reads, _truth = db
    work = [root / "pipe_cpu", root / "pipe_card"]
    for dev, wd in zip(("cpu", cuda), work):
        icm_cuda.reset_launches()
        pipe.run_pipeline(str(root / "reads.fa"), str(icm_dir), device=dev,
                          cluster_device=True, workdir=str(wd))
    assert icm_cuda.launches > 0 and icm_cuda.bank_walk_launches > 0
    names = sorted(p.name for p in work[0].glob("reads*.predict"))
    assert "reads.predict" in names and any("cluster-" in n for n in names)
    for name in names:
        assert (work[1] / name).read_bytes() == (work[0] / name).read_bytes(), \
            name
