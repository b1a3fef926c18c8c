"""One pass of every mesh path over a world of ranks, at toy sizes.

Counterpart of ``__graft_entry__.py::dryrun_multichip``: over a (data,
model) mesh of every rank of the world it runs one sharded EM training
step (``parallel.classify.em_step``), the sharded bank-walk step
(``classify_step_kernel_sharded``), the pipeline's clustering entry point
(``pipeline.scimm.scimm_cluster(mesh=)``) and data-sharded device
prediction (``parallel.predict.predict_batch_sharded``: the six-frame
kernel and the event DP on each rank's reads).

    python -m glimmer_mg_torch.parallel.dryrun --ranks 4 --device cpu

starts that many ranks on this machine (``parallel.launch``) and prints
one line from each; under a launcher (torchrun) it runs as one of its
ranks. ``--backend`` names another backend than the device's own.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from ..models import dna, icm as icm_mod, icm_train
from ..ops import device_predict as dpk, icm_cuda, icm_score
from . import classify as pclassify, mesh as pmesh


def _tiny_bank(n_models, model_len=12, depth=3, rng=None):
    rng = rng or np.random.default_rng(0)
    icms = []
    for _ in range(n_models):
        seqs = ["".join(rng.choice(list("acgt"), 200)) for _ in range(8)]
        icms.append(icm_train.train_icm([dna.encode(s) for s in seqs],
                                        model_len=model_len, depth=depth))
    return icm_score.stack_bank(icms)


def dryrun_multichip(device) -> dict:
    """Run every mesh path once in this rank of an initialised world, over
    a (data, model) mesh of all its ranks: 2 models, so (n/2, 2) for an
    even world of n. ``device`` is this rank's. Returns what each step
    made (shapes and counts); raises when a result is malformed."""
    from ..engine import orfs as orf_mod
    from ..engine.glimmer3 import Models
    from ..pipeline.scimm import scimm_cluster
    from .predict import predict_batch_sharded

    n_devices = torch.distributed.get_world_size()
    n_models = 2
    dp = max(1, n_devices // n_models)
    mp = n_devices // dp
    mesh = pmesh.make_mesh(dp, mp, device=device)
    done = {"mesh": (dp, mp)}

    rng = np.random.default_rng(0)  # the same data on every rank
    depth = 2
    mip, probs = _tiny_bank(n_models=n_models, depth=depth, rng=rng)
    batch = 4 * dp
    reads = rng.integers(0, 4, size=(batch, 64), dtype=np.int32)
    lengths = np.full(batch, 64, dtype=np.int32)

    # one full EM training step: the exact walk on each (read x model)
    # block, the assignment, the counts summed over the data group
    mip_p, probs_p = pmesh.pad_models(mesh, mip, probs)
    new_mip, new_probs, best, scores = pclassify.em_step(
        *pmesh.shard_bank(mesh, mip_p, probs_p, device=device),
        *pmesh.shard_reads(mesh, reads, lengths, device),
        n_models=n_models, model_len=12, depth=depth, mesh=mesh)
    assert scores.shape == (batch, n_models), scores.shape
    assert new_mip.shape[0] == n_models and best.shape == (batch,)
    done["em_step"] = (tuple(scores.shape), int(new_mip.shape[0]))

    # the sharded bank walk (the classification fast path), L % 3 == 0
    lm, pk = icm_cuda.pack_tables(mip_p, probs_p, depth=depth)
    reads3 = np.pad(reads, ((0, 0), (0, (-reads.shape[1]) % 3)))
    k2_scores, k2_best = pclassify.classify_step_kernel_sharded(
        mesh, *pmesh.shard_bank(mesh, lm, pk, device=device),
        *pmesh.shard_reads(mesh, reads3, lengths, device), 12, depth)
    assert k2_scores.shape[0] == batch and k2_best.shape == (batch,)
    done["bank_walk"] = tuple(k2_scores.shape)

    # the pipeline's clustering entry point over the same mesh
    seqs = ["".join(rng.choice(list("acgt"), 60)) for _ in range(batch)]
    init = np.arange(batch, dtype=np.int32) % n_models
    assign, icms, _scores = scimm_cluster(
        seqs, init, n_models, max_iters=2, use_device=True, device=device,
        mesh=mesh, depth=depth)
    assert len(assign) == batch and len(icms) == n_models
    done["scimm"] = len(icms)

    # data-sharded device prediction: each rank runs the six-frame kernel
    # and the event DP on its reads; only the gene records are gathered.
    # max_olap_bases=24 keeps the toy scale (66 bp reads, min_gene_len=33)
    # inside the DP's acyclicity guard (min_gene_len > max_olap + 3).
    pat = orf_mod.CodonPatterns.make()
    train = ["atg" + "".join(rng.choice(list("acgt"), 120))
             for _ in range(6)]
    gene_icm = icm_train.train_icm([dna.encode(s) for s in train],
                                   model_len=12, depth=depth)
    indep = icm_mod.build_indep_wo_stops(0.5, pat.stop_codons)
    models = Models(gene_icm=gene_icm, indep_model=indep, patterns=pat,
                    min_gene_len=33, max_olap_bases=24,
                    allow_truncated_orfs=True)
    bank = dpk.build_bank([models], max_read_len=66)
    n_reads = 4 * dp
    dreads = rng.integers(0, 4, size=(n_reads, 66)).astype(np.int32)
    dlens = np.full(n_reads, 66, np.int32)
    outs = predict_batch_sharded(mesh, bank, dpk.bank_to_device(bank, device),
                                 dreads, dlens, np.zeros(n_reads, np.int32))
    genes, overflow = dpk.finish_genes(outs, n_reads)
    assert len(genes) == n_reads and not overflow.any()
    done["predict"] = sum(len(g) for g in genes)
    return done


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4,
                    help="ranks to start when not run under a launcher")
    ap.add_argument("--device", default="cuda",
                    help="cpu, or cuda (each rank on cuda:<local rank>)")
    ap.add_argument("--backend", default=None,
                    help="the process group's backend (default: nccl on "
                         "cuda, gloo on cpu)")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds the started ranks may take")
    a = ap.parse_args(argv)
    if "RANK" not in os.environ:
        from .launch import run_local

        argv = ["-m", "glimmer_mg_torch.parallel.dryrun", "--device",
                a.device] + (["--backend", a.backend] if a.backend else [])
        for out in run_local(argv, a.ranks, timeout=a.timeout):
            print(out.strip().splitlines()[-1])
        return 0
    if not pmesh.init_distributed(device=a.device, backend=a.backend):
        raise RuntimeError("no world to join")
    try:
        device = pmesh.rank_device(a.device)
        done = dryrun_multichip(device)
        print(f"dryrun rank {torch.distributed.get_rank()} of "
              f"{torch.distributed.get_world_size()} on {device}: {done}",
              flush=True)
    finally:
        pmesh.destroy()
    return 0


if __name__ == "__main__":
    sys.exit(main())
