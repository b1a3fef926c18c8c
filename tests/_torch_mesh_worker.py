"""One rank of the port's mesh tests (tests/test_torch_mesh.py), on the CPU.

    python -m tests._torch_mesh_worker <dir>

runs as a rank started by ``glimmer_mg_torch.parallel.launch.run_local``:
it joins the world (gloo), reads the task list ``<dir>/tasks.json`` and
the inputs ``<dir>/case.npz``, runs each task over the meshes it names,
and writes what it computed to ``<dir>/rank<r>.npz``. It imports the port
and numpy only; the tests hold its results to the JAX package's.

``toy_predict_inputs`` is shared with the tests: the recipe of
tests/test_multichip_dryrun.py::toy_predict_setup, run with either
package's modules.
"""

from __future__ import annotations

import json
import os
import sys
import types

import numpy as np


def toy_predict_inputs(m: types.SimpleNamespace):
    """The toy prediction setup of tests/test_multichip_dryrun.py (a gene
    ICM of depth 3 trained on 8 GC-0.62 genes, 32 reads of up to 402 bp,
    each holding one gene) built with the modules in ``m`` (``orfs``,
    ``Models``, ``dna``, ``icm``, ``icm_train``, ``dpk``). Returns (models,
    bank, reads, lengths, groups)."""
    rng = np.random.default_rng(7)
    pat = m.orfs.CodonPatterns.make()
    gc = 0.62
    p = [(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2]

    def gene_like(ncod):
        cs = []
        while len(cs) < ncod:
            c = "".join(rng.choice(list("acgt"), 3, p=p))
            if c not in ("taa", "tag", "tga"):
                cs.append(c)
        return "atg" + "".join(cs) + str(rng.choice(["taa", "tag", "tga"]))

    train = [gene_like(120) for _ in range(8)]
    gene_icm = m.icm_train.train_icm([m.dna.encode(s) for s in train],
                                     model_len=12, depth=3)
    indep = m.icm.build_indep_wo_stops(0.5, pat.stop_codons)
    models = m.Models(gene_icm=gene_icm, indep_model=indep, patterns=pat,
                      min_gene_len=75, allow_truncated_orfs=True)
    L = 402
    bank = m.dpk.build_bank([models], max_read_len=L)
    n_reads = 32
    seqs = []
    for _ in range(n_reads):
        s = ("".join(rng.choice(list("acgt"), int(rng.integers(10, 60))))
             + gene_like(int(rng.integers(40, 100)))
             + "".join(rng.choice(list("acgt"), int(rng.integers(10, 60)))))
        seqs.append(s[:L])
    lengths = np.array([len(s) for s in seqs], np.int32)
    reads = np.zeros((n_reads, L), np.int32)
    for i, s in enumerate(seqs):
        reads[i, :len(s)] = m.dna.encode(s)
    return models, bank, reads, lengths, np.zeros(n_reads, np.int32)


def port_modules():
    from glimmer_mg_torch.engine import orfs
    from glimmer_mg_torch.engine.glimmer3 import Models
    from glimmer_mg_torch.models import dna, icm, icm_train
    from glimmer_mg_torch.ops import device_predict as dpk

    return types.SimpleNamespace(orfs=orfs, Models=Models, dna=dna, icm=icm,
                                 icm_train=icm_train, dpk=dpk)


def gene_rows(genes_per_read):
    """tests/test_multichip_dryrun.py::_gene_rows."""
    rows = []
    for r, genes in enumerate(genes_per_read):
        for g in genes:
            rows.append("%d %05d %d %d %+d %8.2f %d" % (
                r, g.id, g.start, g.stop, g.frame, g.score, int(g.truncated)))
    return rows


def _classify(mesh, tag, case, out, task):
    from glimmer_mg_torch.parallel import classify as pcl, mesh as pmesh

    lm, pk = pmesh.pad_models(mesh, case["lm"], case["pk"])
    reads, lengths, n = pmesh.pad_batch(mesh, case["reads"], case["lengths"])
    scores, best = pcl.classify_step_kernel_sharded(
        mesh, *pmesh.shard_bank(mesh, lm, pk, device="cpu"),
        *pmesh.shard_reads(mesh, reads, lengths, "cpu"), 12, 7)
    out[f"classify_{tag}_scores"] = scores
    out[f"classify_{tag}_best"] = best
    out[f"classify_{tag}_n"] = np.array([n, len(lm)])


def _em_step(mesh, tag, case, out, task):
    from glimmer_mg_torch.parallel import classify as pcl, mesh as pmesh

    mip, probs = pmesh.pad_models(mesh, case["mip"], case["probs"])
    reads, lengths, n = pmesh.pad_batch(mesh, case["reads"], case["lengths"])
    new_mip, new_probs, best, scores = pcl.em_step(
        *pmesh.shard_bank(mesh, mip, probs, device="cpu"),
        *pmesh.shard_reads(mesh, reads, lengths, "cpu"),
        n_models=len(case["mip"]), mesh=mesh)
    out[f"em_step_{tag}_mip"] = new_mip.numpy()
    out[f"em_step_{tag}_probs"] = new_probs.numpy()
    out[f"em_step_{tag}_best"] = best
    out[f"em_step_{tag}_scores"] = scores


def _pad(mesh, tag, case, out, task):
    from glimmer_mg_torch.parallel import mesh as pmesh

    reads, lengths, n = pmesh.pad_batch(mesh, case["reads"][:5],
                                        case["lengths"][:5])
    out[f"pad_{tag}_reads"], out[f"pad_{tag}_lengths"] = reads, lengths
    out[f"pad_{tag}_n"] = np.array(n)


def _classify_file(mesh, tag, case, out, task):
    from glimmer_mg_torch.parallel import phymm

    out_dir = task["out_dir"].format(tag=tag)
    os.makedirs(out_dir, exist_ok=True)
    _p, _r, scores = phymm.classify_file(task["reads"], task["icm_dir"],
                                         out_dir=out_dir, device="cpu",
                                         mesh=mesh)
    out[f"classify_file_{tag}_scores"] = scores


def _classify_shares(mesh, tag, case, out, task):
    """classify_file on each of ``task["files"]``, without and with a bank
    built before, every rank into one directory a run; the last file's
    run without a bank under the recorder (its span names and counters)."""
    from glimmer_mg_torch.parallel import phymm
    from glimmer_mg_torch.utils import observe

    bank = phymm.PhymmBank.from_genome_data(task["icm_dir"], "cpu", mesh)
    for k, fa in enumerate(task["files"]):
        for built in (None, bank):
            name = f"shares_{tag}_{k}_{'bank' if built else 'nobank'}"
            out_dir = os.path.join(task["out_dir"], name)
            os.makedirs(out_dir, exist_ok=True)
            probe = k == len(task["files"]) - 1 and built is None
            if probe:
                observe.reset()
                observe.enable()
            try:
                _p, ids, scores = phymm.classify_file(
                    fa, task["icm_dir"], out_dir=out_dir, device="cpu",
                    mesh=mesh, bank=built)
            finally:
                observe.disable()
            out[f"{name}_scores"] = scores
            out[f"{name}_ids"] = np.array(ids, dtype=str)
            if probe:
                snap = observe.snapshot()
                out[f"{name}_spans"] = np.array(
                    sorted({sp.name for sp in snap["spans"]}), dtype=str)
                out[f"{name}_counters"] = np.array(
                    [snap["counters"].get(c, -1) for c in
                     ("mesh_collectives", "mesh_bytes")])
                observe.reset()


def _scimm(mesh, tag, case, out, task):
    from glimmer_mg_torch.pipeline import scimm

    assign, icms, scores = scimm.scimm_cluster(
        [str(s) for s in case["seqs"]], case["init"], 2, use_device=True,
        device="cpu", mesh=mesh)
    out[f"scimm_{tag}_assign"] = assign
    out[f"scimm_{tag}_mip"] = np.stack([m.mip for m in icms])
    out[f"scimm_{tag}_probs"] = np.stack([m.probs for m in icms])
    out[f"scimm_{tag}_scores"] = scores


def _predict(mesh, tag, case, out, task):
    from glimmer_mg_torch.ops import device_predict as dpk
    from glimmer_mg_torch.parallel.predict import predict_batch_sharded

    _models, bank, reads, lengths, groups = toy_predict_inputs(
        port_modules())
    outs = predict_batch_sharded(mesh, bank, dpk.bank_to_device(bank, "cpu"),
                                 reads, lengths, groups)
    genes, overflow = dpk.finish_genes(outs, len(reads))
    out[f"predict_{tag}_rows"] = np.array(gene_rows(genes))
    out[f"predict_{tag}_overflow"] = overflow


TASKS = {"classify": _classify, "em_step": _em_step, "pad": _pad,
         "classify_file": _classify_file, "scimm": _scimm,
         "classify_shares": _classify_shares,
         "predict": _predict}


def main(work):
    import torch

    from glimmer_mg_torch.parallel import mesh as pmesh

    torch.set_num_threads(1)
    with open(os.path.join(work, "tasks.json")) as fh:
        tasks = json.load(fh)
    case = dict(np.load(os.path.join(work, "case.npz")))
    assert pmesh.init_distributed(device="cpu")
    out = {}
    try:
        for task in tasks:
            for data, model in task["meshes"]:
                mesh = pmesh.make_mesh(data, model, device="cpu")
                TASKS[task["name"]](mesh, f"{data}x{model}", case, out, task)
        np.savez(os.path.join(work, f"rank{os.environ['RANK']}.npz"), **out)
    finally:
        pmesh.destroy()


if __name__ == "__main__":
    main(sys.argv[1])
