"""The port's CLI over a mesh of gloo ranks on the CPU (``--device cpu``).

* ``classify --mesh 1,2 --coordinator --num_procs 2 --proc_id`` on 2
  processes (the counterpart of tests/test_multihost.py:53): the raw
  matrix and the results table byte-identical to a one-process run,
  written by process 0 only;
* ``classify --mesh 4,1`` on 4 ranks under a launcher's environment: the
  ranks' shares of both files in one directory, byte-identical to a
  one-process run;
* ``glimmer-mg-pipeline --mesh 2,1 --iterate 1`` on 2 ranks under a
  launcher's environment, on the 2-genome fixture database of
  tests/_torch_common.py: every file of the work directory byte-identical
  to the one-process ``run_pipeline`` on the same EM route (a mesh implies
  the device EM), both ranks printing the final path. The final
  ``.predict`` orders each cluster's reads by the process's string
  hashes (``combine_predictions`` iterates over a set), so both runs get
  ``PYTHONHASHSEED=0``;
* the parser errors: a half-given multi-host spec, and data x model !=
  the world size (a launcher's world of 1 rank, in this process).
"""

import shutil
from pathlib import Path

import pytest
import torch.distributed as dist

from glimmer_mg_torch import cli as tcli
from glimmer_mg_torch.parallel import phymm as tphymm
from glimmer_mg_torch.parallel.launch import free_port, run_local

from tests._torch_common import mg_db, one_torch_thread  # noqa: F401
from tests.test_torch_mesh import LAUNCH_ENV, RANK_TIMEOUT, _rank_env

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = Path(__file__).resolve().parent.parent
CLI = ["-m", "glimmer_mg_torch.cli"]


def _files(d):
    return {str(p.relative_to(d)): p.read_bytes()
            for p in sorted(d.rglob("*")) if p.is_file()}


def test_classify_on_two_processes(mg_db, tmp_path):
    root, icm_dir, _reads, _truth = mg_db
    fa = str(root / "reads.fa")
    for r in range(2):
        (tmp_path / f"proc{r}").mkdir()
    run_local(CLI + ["classify", fa, str(icm_dir), "-o",
                     str(tmp_path / "proc{rank}"), "--mesh", "1,2",
                     "--coordinator", f"127.0.0.1:{free_port()}",
                     "--num_procs", "2", "--proc_id", "{rank}",
                     "--device", "cpu"],
              2, timeout=RANK_TIMEOUT, env=_rank_env(), cwd=REPO)
    (tmp_path / "single").mkdir()
    assert tcli.main(["classify", fa, str(icm_dir), "-o",
                      str(tmp_path / "single"), "--device", "cpu"]) == 0
    assert not dist.is_initialized()
    want = _files(tmp_path / "single")
    assert set(want) == {tphymm.raw_phymm_name(fa), tphymm.results_name(fa),
                         "reads_fa_progress.txt"}
    assert _files(tmp_path / "proc0") == want
    assert _files(tmp_path / "proc1") == {}


def test_classify_read_sharded_under_a_launcher(mg_db, tmp_path):
    """``classify --mesh 4,1`` on 4 ranks under a launcher's environment
    (one host): each rank writes its share into the one directory; both
    files and the progress file byte-identical to a one-process run."""
    root, icm_dir, _reads, _truth = mg_db
    fa = str(root / "reads.fa")
    for d in ("mesh", "single"):
        (tmp_path / d).mkdir()
    run_local(CLI + ["classify", fa, str(icm_dir), "-o",
                     str(tmp_path / "mesh"), "--mesh", "4,1", "--batch", "7",
                     "--device", "cpu"],
              4, timeout=RANK_TIMEOUT, env=_rank_env(), cwd=REPO)
    assert tcli.main(["classify", fa, str(icm_dir), "-o",
                      str(tmp_path / "single"), "--device", "cpu"]) == 0
    want = _files(tmp_path / "single")
    assert len(want) == 3
    assert _files(tmp_path / "mesh") == want


def test_pipeline_mesh_matches_one_process(mg_db, tmp_path):
    root, icm_dir, _reads, _truth = mg_db
    fa = tmp_path / "reads.fa"
    shutil.copy(root / "reads.fa", fa)
    env = dict(_rank_env(), PYTHONHASHSEED="0")
    args = [str(fa), str(icm_dir), "--iterate", "1", "--device", "cpu"]
    outs = run_local(CLI + ["glimmer-mg-pipeline", *args, "--workdir",
                            str(tmp_path / "mesh"), "--mesh", "2,1"],
                     2, timeout=RANK_TIMEOUT, env=env, cwd=REPO)
    final = str(tmp_path / "mesh" / "reads.predict")
    assert [o.strip().splitlines()[-1] for o in outs] == [final, final]
    code = ("import sys; from glimmer_mg_torch.pipeline.glimmer_mg_pipe "
            "import run_pipeline; run_pipeline(sys.argv[1], sys.argv[2], "
            "device='cpu', iterate=1, cluster_device=True, "
            "workdir=sys.argv[3])")
    run_local(["-c", code, str(fa), str(icm_dir), str(tmp_path / "single")],
              1, timeout=RANK_TIMEOUT, env=env, cwd=REPO)
    mine, want = _files(tmp_path / "mesh"), _files(tmp_path / "single")
    assert "reads.predict" in want and "cluster-1.icm" in want
    assert set(mine) == set(want)
    for name in want:
        assert mine[name] == want[name], name


@pytest.fixture
def no_launcher(monkeypatch):
    for k in LAUNCH_ENV:
        monkeypatch.delenv(k, raising=False)


@pytest.mark.parametrize("argv,message", [
    (["classify", "r.fa", "db", "--coordinator", "127.0.0.1:1",
      "--num_procs", "2"], "must be given together"),
    (["classify", "r.fa", "db", "--num_procs", "2", "--proc_id", "2",
      "--coordinator", "127.0.0.1:1"], "0 <= proc_id < num_procs"),
    (["glimmer-mg-pipeline", "r.fa", "db", "--mesh", "2"],
     "expected DATA,MODEL"),
], ids=["half-spec", "bad-proc-id", "bad-mesh"])
def test_bad_multihost_spec_is_a_parser_error(no_launcher, capsys, argv,
                                              message):
    with pytest.raises(SystemExit) as exc:
        tcli.main(argv + ["--device", "cpu"])
    assert exc.value.code == 2
    assert message in capsys.readouterr().err
    assert not dist.is_initialized()


@pytest.mark.parametrize("command", ["classify", "glimmer-mg-pipeline"])
def test_mesh_not_the_world_size_is_a_parser_error(no_launcher, monkeypatch,
                                                   capsys, command):
    """A launcher's world of one rank and --mesh 2,1."""
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(free_port()))
    with pytest.raises(SystemExit) as exc:
        tcli.main([command, "r.fa", "db", "--mesh", "2,1", "--device",
                   "cpu"])
    assert exc.value.code == 2
    assert "mesh 2x1 != 1 ranks" in capsys.readouterr().err
    assert not dist.is_initialized()
