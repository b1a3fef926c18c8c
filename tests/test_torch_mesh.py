"""The port's (data, model) mesh on torch.distributed (gloo ranks on the
CPU) against the port's one-rank runs and the JAX package's mesh.

* the helpers: ``init_distributed`` is a no-op without a launcher's
  environment or with one process, and raises (and leaves no world) on a
  half-given spec, a bad process id, a half-set environment or a
  coordinator nobody serves; ``make_mesh`` and ``pad_batch`` follow
  ``glimmer_mg_tpu.parallel.mesh``: the mesh's shape and axis names, the
  ValueError when data x model != the world, the pads;
* sharded classification on 1x2 and 2x1 meshes of 2 ranks and a 2x2 mesh
  of 4: ``classify_step_kernel_sharded`` (a bank of 3 depth-7 ICMs padded
  to the model axis, 9 reads padded to the data axis) BITWISE equal to the
  one-rank ``classify_step_kernel`` and to JAX's
  ``classify_step_pallas_sharded(interpret=True)`` on the same blocks; the
  argmax equal;
* the sharded ``em_step`` on 1x2 (the 3-model bank padded) and 2x1 (the
  batch padded): the retrained bank, the assignment and the exact walk's
  scores bitwise equal to the one-rank ``em_step``;
* ``classify_file(mesh=)`` on 1x2 and 2x1: the raw matrix and the results
  table byte-identical to the one-process port's and to JAX's
  ``classify_file(mesh=)`` (its TPU branch on the CPU, patched as in
  tests/test_torch_scimm.py); the ranks share one host, so every rank
  writes its share into the one output directory;
* the read-sharded ``classify_file`` on 2x1, 4x1 and 2x2 over files of 1,
  3, 5 and 37 reads of varied lengths (an empty one among them), with and
  without a bank built before: both files and the progress file
  byte-identical to the one-rank run's, and every rank returning every
  read id and the whole matrix; on the 37-read file, the spans of the
  mesh branch recorded and ``mesh_bytes`` equal to the bytes of the
  gathered blocks (five collectives);
* data-sharded device prediction on 2 ranks, on the toy setup of
  tests/test_multichip_dryrun.py::toy_predict_setup: gene records and
  overflow flags equal to the port's unsharded ``predict_batch_device``
  and to JAX's data-sharded run;
* the dryrun (``parallel.dryrun``) on a world of 4 ranks;
* ``parallel.launch.run_local`` raises, and leaves no rank running, when a
  rank fails or the ranks outlast their time limit.

The sharded EM is held in tests/test_torch_mesh_em.py.

Every rank's results are the same; the ranks run torch on one thread,
each launch within its own time limit (``parallel.launch.run_local``).
"""

import datetime
import functools
import json
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding, PartitionSpec as P

from glimmer_mg_tpu.engine import orfs as jorfs
from glimmer_mg_tpu.engine.glimmer3 import Models as JModels
from glimmer_mg_tpu.models import dna as jdna, icm as jicm, icm_train as jit
from glimmer_mg_tpu.ops import device_predict as jdpk, icm_pallas
from glimmer_mg_tpu.ops import icm_score as jis
from glimmer_mg_tpu.parallel import classify as jcl, mesh as jmesh
from glimmer_mg_tpu.parallel import phymm as jphymm
from glimmer_mg_torch.io import fasta_share
from glimmer_mg_torch.ops import device_predict as tdpk, icm_cuda
from glimmer_mg_torch.parallel import classify as tcl, dryrun
from glimmer_mg_torch.parallel import mesh as tmesh, phymm as tphymm
from glimmer_mg_torch.parallel.launch import free_port, run_local

from tests import _torch_mesh_worker as worker
from tests._torch_common import mg_db  # noqa: F401
from tests._torch_common import one_torch_thread  # noqa: F401
from tests.test_torch_classify import _icms

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = Path(__file__).resolve().parent.parent
RANK_TIMEOUT = 150  # seconds for one launch of ranks
LAUNCH_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
              "LOCAL_RANK")
LENGTHS = [126, 100, 50, 9, 0, 77, 126, 31, 64]
SHARE_READS = (1, 3, 5, 37)


def bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _rank_env():
    env = {k: v for k, v in os.environ.items() if k not in LAUNCH_ENV}
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def jax_mesh(data, model):
    return jmesh.make_mesh(data=data, model=model,
                           devices=jax.devices()[:data * model])


def jax_tpu_branch(mp):
    """The JAX package's TPU branch on the CPU: the Pallas walk in
    interpret mode (``groups=1, e_block=128`` change only the TPU
    layout)."""
    mp.setattr(jax, "default_backend", lambda: "tpu")
    mp.setattr(icm_pallas, "bank_score_reads_pallas",
               functools.partial(icm_pallas.bank_score_reads_pallas,
                                 groups=1, e_block=128))
    mp.setattr(jcl, "classify_step_pallas_sharded",
               functools.partial(jcl.classify_step_pallas_sharded,
                                 interpret=True))


def _pad_models(a, model):
    pad = (-a.shape[0]) % model
    return np.concatenate([a, np.repeat(a[:1], pad, 0)]) if pad else a


@pytest.fixture(scope="module")
def case():
    """A bank of 3 depth-7 ICMs (one pruned), its packed tables and 9
    reads with a length-0 one among them."""
    mip, probs = jis.stack_bank(_icms())
    lm, pk = icm_pallas.pack_tables(mip, probs)
    rng = np.random.default_rng(8)
    reads = rng.integers(0, 4, (len(LENGTHS), 126), dtype=np.int32)
    lengths = np.array(LENGTHS, np.int32)
    for r, n in enumerate(lengths):
        reads[r, n:] = 0
    return {"mip": mip, "probs": probs, "lm": np.asarray(lm),
            "pk": np.asarray(pk), "reads": reads, "lengths": lengths}


def launch(work, tasks, case, n):
    """Run the worker on ``n`` ranks; returns each rank's results."""
    os.makedirs(work, exist_ok=True)
    with open(os.path.join(work, "tasks.json"), "w") as fh:
        json.dump(tasks, fh)
    np.savez(os.path.join(work, "case.npz"), **case)
    run_local(["-m", "tests._torch_mesh_worker", str(work)], n,
              timeout=RANK_TIMEOUT, env=_rank_env(), cwd=REPO)
    return [dict(np.load(os.path.join(work, f"rank{r}.npz")))
            for r in range(n)]


@pytest.fixture(scope="module")
def share_files(tmp_path_factory, mg_db):
    """FASTA files of 1, 3, 5 and 37 reads cut to varied lengths (the
    second read of the 37 empty), lines of 60 or 37 bases."""
    _root, _icm_dir, reads, _truth = mg_db
    d = tmp_path_factory.mktemp("shares")
    rng = np.random.default_rng(21)
    files = []
    for n in SHARE_READS:
        lines = []
        for i in range(n):
            h, s = reads[i % len(reads)]
            s = s[:int(rng.integers(1, len(s) + 1))] if i % 3 else s
            s = "" if (n, i) == (37, 1) else s
            width = 60 if n % 2 else 37
            lines.append(f">{h.split()[0]}_{i} read {i}\n")
            lines += [s[j:j + width] + "\n" for j in range(0, len(s), width)]
        path = d / f"reads{n}.fa"
        path.write_text("".join(lines))
        files.append(str(path))
    return files


def _shares_task(work, mg_db, share_files, meshes):
    _root, icm_dir, _reads, _truth = mg_db
    return {"name": "classify_shares", "meshes": meshes,
            "files": share_files, "icm_dir": str(icm_dir),
            "out_dir": str(work)}


@pytest.fixture(scope="module")
def world2(tmp_path_factory, case, mg_db, share_files):
    """Every task on 2 ranks, launched once."""
    root, icm_dir, _reads, _truth = mg_db
    work = tmp_path_factory.mktemp("mesh2")
    tasks = [
        {"name": "pad", "meshes": [[2, 1]]},
        {"name": "classify", "meshes": [[1, 2], [2, 1]]},
        {"name": "em_step", "meshes": [[1, 2], [2, 1]]},
        {"name": "classify_file", "meshes": [[1, 2], [2, 1]],
         "reads": str(root / "reads.fa"), "icm_dir": str(icm_dir),
         "out_dir": str(work / "cf_{tag}")},
        {"name": "predict", "meshes": [[2, 1]]},
        _shares_task(work, mg_db, share_files, [[2, 1]]),
    ]
    return work, launch(work, tasks, case, 2)


@pytest.fixture(scope="module")
def world4(tmp_path_factory, case, mg_db, share_files):
    work = tmp_path_factory.mktemp("mesh4")
    tasks = [{"name": "classify", "meshes": [[2, 2]]},
             _shares_task(work, mg_db, share_files, [[4, 1], [2, 2]])]
    return work, launch(work, tasks, case, 4)


def same_on_every_rank(ranks, prefix):
    keys = sorted(k for k in ranks[0] if k.startswith(prefix))
    assert keys
    for other in ranks[1:]:
        assert sorted(k for k in other if k.startswith(prefix)) == keys
        for k in keys:
            assert np.array_equal(ranks[0][k], other[k]), k
    return ranks[0]


# ---- the helpers ----------------------------------------------------------


@pytest.fixture
def no_launcher(monkeypatch):
    for k in LAUNCH_ENV:
        monkeypatch.delenv(k, raising=False)
    yield
    assert not dist.is_initialized()


def test_init_distributed_is_a_noop_without_a_world(no_launcher):
    assert tmesh.init_distributed(device="cpu") is False
    assert tmesh.init_distributed("127.0.0.1:1", 1, 0, device="cpu") is False
    assert not dist.is_initialized()
    assert tmesh.is_output_process()
    assert tmesh.default_backend("cuda") == "nccl"
    assert tmesh.default_backend("cpu") == "gloo"
    with pytest.raises(RuntimeError, match="initialised process group"):
        tmesh.make_mesh(device="cpu")


@pytest.mark.parametrize("args,env,exc", [
    (("127.0.0.1:1", 2, None), {}, ValueError),
    ((None, 2, 0), {}, ValueError),
    (("127.0.0.1:1", 2, 2), {}, ValueError),
    ((), {"RANK": "0"}, ValueError),
    (("127.0.0.1:{port}", 2, 1), {}, RuntimeError),
], ids=["half-spec", "no-coordinator", "bad-proc-id", "half-env",
        "nobody-serves"])
def test_init_distributed_raises(no_launcher, monkeypatch, args, env, exc):
    """No fallback: a failed init raises and leaves no world."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if args:
        args = (args[0] and args[0].format(port=free_port()),) + args[1:]
    with pytest.raises(exc):
        tmesh.init_distributed(*args, device="cpu",
                               timeout=datetime.timedelta(seconds=2))
    assert not dist.is_initialized()


@pytest.fixture
def one_rank_world(no_launcher, tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_make_mesh_follows_jax(one_rank_world, case):
    mesh = tmesh.make_mesh(device="cpu")
    want = jax_mesh(1, 1)
    assert mesh.mesh_dim_names == tuple(want.axis_names)
    assert tuple(mesh.shape) == tuple(want.shape.values()) == (1, 1)
    assert tmesh.is_output_process()
    for data, model in ((2, 1), (1, 2), (2, None), (None, 2)):
        with pytest.raises(ValueError, match=r"mesh \d+x\d+ != 1 ranks"):
            tmesh.make_mesh(data, model, device="cpu")
        with pytest.raises(ValueError, match=r"mesh \d+x\d+ != 1 devices"):
            jmesh.make_mesh(data, model, devices=jax.devices()[:1])
    # one rank: the pads are none, the blocks are the whole arrays
    reads, lengths, n = tmesh.pad_batch(mesh, case["reads"], case["lengths"])
    assert n == len(LENGTHS) and reads is case["reads"]
    x = torch.arange(6.0).reshape(2, 3)
    assert np.array_equal(tmesh.materialize(mesh, x), x.numpy())
    got = tmesh.shard_bank(mesh, case["lm"], case["pk"], device="cpu")
    assert all(np.array_equal(g.numpy(), case[k])
               for g, k in zip(got, ("lm", "pk")))


def test_pad_batch_follows_jax(world2, case):
    _work, ranks = world2
    got = same_on_every_rank(ranks, "pad_")
    want = jmesh.pad_batch(jax_mesh(2, 1), case["reads"][:5],
                           case["lengths"][:5])
    assert got["pad_2x1_reads"].shape == (6, 126)
    assert np.array_equal(got["pad_2x1_reads"], want[0])
    assert np.array_equal(got["pad_2x1_lengths"], want[1])
    assert got["pad_2x1_lengths"][5] == 0 and int(got["pad_2x1_n"]) == want[2]


# ---- sharded classification -----------------------------------------------


@pytest.fixture(scope="module")
def one_rank(case):
    """The port's unsharded two-strand bank walk (the kernel's twin)."""
    scores, best = tcl.classify_step_kernel(
        *(torch.from_numpy(case[k]) for k in ("lm", "pk", "reads",
                                              "lengths")), 12, 7)
    return scores.numpy(), best.numpy()


def _jax_sharded(case, data, model):
    mesh = jax_mesh(data, model)
    reads, lengths, _n = jmesh.pad_batch(mesh, case["reads"], case["lengths"])
    ms = NamedSharding(mesh, P("model"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(icm_pallas, "bank_score_reads_pallas",
                   functools.partial(icm_pallas.bank_score_reads_pallas,
                                     groups=1, e_block=128))
        scores, best = jcl.classify_step_pallas_sharded(
            mesh, *(jax.device_put(_pad_models(case[k], model), ms)
                    for k in ("lm", "pk")),
            *jmesh.shard_reads(mesh, reads, lengths), 12, 7, interpret=True)
    return np.asarray(scores), np.asarray(best)


@pytest.mark.parametrize("world,data,model", [(2, 1, 2), (2, 2, 1),
                                              (4, 2, 2)])
def test_sharded_classification_bitwise(request, case, one_rank, world, data,
                                        model):
    _work, ranks = request.getfixturevalue(f"world{world}")
    tag = f"classify_{data}x{model}"
    got = same_on_every_rank(ranks, tag)
    n, m = len(LENGTHS), case["lm"].shape[0]
    scores, best = got[f"{tag}_scores"], got[f"{tag}_best"]
    assert scores.shape == (n + (-n) % data, m + (-m) % model)
    assert tuple(got[f"{tag}_n"]) == (n, m + (-m) % model)
    want, want_best = one_rank
    assert np.array_equal(bits(scores[:n, :m]), bits(want))
    assert np.array_equal(best[:n], want_best)
    j_scores, j_best = _jax_sharded(case, data, model)
    assert np.array_equal(bits(scores), bits(j_scores))
    assert np.array_equal(best, j_best)


@pytest.mark.parametrize("data,model", [(1, 2), (2, 1)])
def test_sharded_em_step_bitwise(world2, case, data, model):
    _work, ranks = world2
    tag = f"em_step_{data}x{model}"
    got = same_on_every_rank(ranks, tag)
    n = len(LENGTHS)
    want = [x.numpy() for x in tcl.em_step(
        *(torch.from_numpy(case[k]) for k in ("mip", "probs", "reads",
                                              "lengths")),
        n_models=case["mip"].shape[0])]
    assert np.array_equal(got[f"{tag}_mip"], want[0])
    assert np.array_equal(bits(got[f"{tag}_probs"]), bits(want[1]))
    assert np.array_equal(got[f"{tag}_best"][:n], want[2])
    assert np.array_equal(bits(got[f"{tag}_scores"][:n]), bits(want[3]))


def test_classify_file_over_a_mesh(world2, mg_db, tmp_path):
    """Raw matrix and results table byte-identical to the one-process
    port's and to JAX's classify_file(mesh=); the ranks share this host,
    so both wrote into the one directory, which holds the three files."""
    work, ranks = world2
    root, icm_dir, _reads, _truth = mg_db
    fa = str(root / "reads.fa")
    single = tmp_path / "single"
    single.mkdir()
    _p, _r, want = tphymm.classify_file(fa, str(icm_dir), out_dir=str(single),
                                        device="cpu")
    names = (tphymm.raw_phymm_name(fa), tphymm.results_name(fa))
    for data, model in ((1, 2), (2, 1)):
        tag = f"{data}x{model}"
        got = same_on_every_rank(ranks, f"classify_file_{tag}")
        assert np.array_equal(bits(got[f"classify_file_{tag}_scores"]),
                              bits(want))
        assert sorted(os.listdir(work / f"cf_{tag}")) == sorted(
            names + ("reads_fa_progress.txt",))
        jdir = tmp_path / f"jax_{tag}"
        jdir.mkdir()
        with pytest.MonkeyPatch.context() as mp:
            jax_tpu_branch(mp)
            jphymm.classify_file(fa, str(icm_dir), out_dir=str(jdir),
                                 mesh=jax_mesh(data, model))
        for name in names:
            mine = (work / f"cf_{tag}" / name).read_bytes()
            assert mine == (single / name).read_bytes(), (tag, name)
            assert mine == (jdir / name).read_bytes(), (tag, name)


@pytest.fixture(scope="module")
def share_singles(tmp_path_factory, mg_db, share_files):
    """The one-rank classify_file of each share file: (ids, scores, {file
    name: bytes})."""
    _root, icm_dir, _reads, _truth = mg_db
    out = []
    for fa in share_files:
        d = tmp_path_factory.mktemp("single")
        _p, ids, scores = tphymm.classify_file(fa, str(icm_dir),
                                               out_dir=str(d), device="cpu")
        out.append((ids, scores, {p.name: p.read_bytes()
                                  for p in d.iterdir()}))
    return out


@pytest.mark.parametrize("world,data,model", [(2, 2, 1), (4, 4, 1),
                                              (4, 2, 2)])
def test_read_sharded_classify_file_byte_identical(request, share_files,
                                                   share_singles, world,
                                                   data, model):
    work, ranks = request.getfixturevalue(f"world{world}")
    for k, (ids, want, files) in enumerate(share_singles):
        assert len(ids) == SHARE_READS[k] and files
        for variant in ("nobank", "bank"):
            name = f"shares_{data}x{model}_{k}_{variant}"
            d = work / name
            assert {p.name: p.read_bytes() for p in d.iterdir()} == files, \
                name
            for r in ranks:  # every rank returns every id and score
                assert list(r[f"{name}_ids"]) == ids, name
                assert np.array_equal(bits(r[f"{name}_scores"]),
                                      bits(want)), name


@pytest.mark.parametrize("world,data,model", [(2, 2, 1), (4, 4, 1),
                                              (4, 2, 2)])
def test_read_sharded_classify_file_spans_and_bytes(request, share_files,
                                                    mg_db, world, data,
                                                    model):
    """On the 37-read file (the probe of each mesh): the mesh branch's
    spans, five collectives a rank, and mesh_bytes = 2 (n - 1) x each
    gather's per-rank bytes: the reads and id bytes (2 int64), the ids
    (the longest share's), the scores (the most reads x this rank's
    models x 4), the text lengths (2 int64)."""
    _work, ranks = request.getfixturevalue(f"world{world}")
    _root, icm_dir, _reads, _truth = mg_db
    name = f"shares_{data}x{model}_{len(share_files) - 1}_nobank"
    shares = [fasta_share.read_share(share_files[-1], i, data)
              for i in range(data)]
    id_bytes = max(len("".join(r + "\n" for r in ids).encode())
                   for ids, _c, _o in shares)
    rows = max(len(ids) for ids, _c, _o in shares)
    models = len(tphymm.genome_icm_paths(str(icm_dir)))
    local = -(-models // model)
    want = 2 * (world - 1) * (16 + id_bytes + rows * local * 4 + 16)
    for r in ranks:
        assert {"phymm.parse", "phymm.score", "phymm.score.pad",
                "phymm.score.fetch", "mesh.offsets", "mesh.gather",
                "mesh.barrier"} <= set(r[f"{name}_spans"])
        assert list(r[f"{name}_counters"]) == [5, want]


# ---- data-sharded prediction ----------------------------------------------


def test_data_sharded_prediction_byte_equal(world2):
    _work, ranks = world2
    got = same_on_every_rank(ranks, "predict_")
    rows, overflow = list(got["predict_2x1_rows"]), got["predict_2x1_overflow"]

    _m, bank, reads, lengths, groups = worker.toy_predict_inputs(
        worker.port_modules())
    t = [torch.from_numpy(a) for a in (reads, lengths, groups)]
    dev = tdpk.bank_to_device(bank, "cpu")
    g6, i6 = icm_cuda.mg_six_frame(dev["gene_mip"], dev["gene_probs"],
                                   dev["indep_mip"], dev["indep_probs"], *t,
                                   model_len=12, depth=3, gene_periodicity=3)
    plain = tdpk.finish_genes(
        tdpk.predict_batch_device(bank, dev, *t, g6, i6), len(reads))
    assert worker.gene_rows(plain[0]) == rows
    assert np.array_equal(plain[1], overflow)

    import types

    jmods = types.SimpleNamespace(orfs=jorfs, Models=JModels, dna=jdna,
                                  icm=jicm, icm_train=jit, dpk=jdpk)
    _m, jbank, jreads, jlens, jgroups = worker.toy_predict_inputs(jmods)
    assert np.array_equal(jreads, reads)
    jg6, ji6 = jis.mg_six_frame_batch(
        jbank.gene_mip, jbank.gene_probs, jbank.indep_mip, jbank.indep_probs,
        jreads, jlens, jgroups, model_len=12, depth=3, gene_periodicity=3)
    ds = NamedSharding(jax_mesh(2, 1), P("data"))
    outs = jdpk.predict_batch_device(
        jbank, *(jax.device_put(np.asarray(a), ds)
                 for a in (jreads, jlens, jgroups, jg6, ji6)),
        cache_key="torch_mesh")
    j_genes, j_overflow = jdpk.finish_genes(outs, len(jreads))
    assert worker.gene_rows(j_genes) == rows
    assert np.array_equal(np.asarray(j_overflow)[:len(jreads)], overflow)
    assert len(rows) > 0  # real genes were found


# ---- the dryrun -----------------------------------------------------------


def test_dryrun_on_four_ranks(no_launcher, monkeypatch, capsys):
    for k, v in _rank_env().items():
        monkeypatch.setenv(k, v)
    monkeypatch.chdir(REPO)
    assert dryrun.main(["--ranks", "4", "--device", "cpu", "--timeout",
                        str(RANK_TIMEOUT)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(" on ")[0] for ln in lines] == [
        f"dryrun rank {r} of 4" for r in range(4)]
    assert all("'mesh': (2, 2)" in ln and "'scimm': 2" in ln
               for ln in lines)


@pytest.mark.parametrize("code,timeout,message", [
    ("import os, sys, time\n"
     "sys.exit(3) if os.environ['RANK'] == '1' else time.sleep(60)",
     60, "ranks [0, 1] of 2 failed"),
    ("import time; time.sleep(60)", 1, "timed out after 1 s"),
], ids=["a-rank-fails", "time-runs-out"])
def test_run_local_leaves_no_rank_behind(code, timeout, message):
    import subprocess
    import time

    started = []
    real = subprocess.Popen

    def popen(*a, **k):
        started.append(real(*a, **k))
        return started[-1]

    t0 = time.monotonic()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(subprocess, "Popen", popen)
        with pytest.raises(RuntimeError, match=message.replace("[", r"\[")):
            run_local(["-c", code], 2, timeout=timeout, env=_rank_env())
    assert time.monotonic() - t0 < 30
    assert len(started) == 2 and all(p.poll() is not None for p in started)

