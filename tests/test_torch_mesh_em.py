"""The Scimm EM of the port sharded over a mesh of 2 gloo ranks on the CPU.

``scimm_cluster(mesh=)``, the device EM (the bank trainer with its counts
summed over the data group, the bank walk's twin on each rank's block of
the cluster bank padded to the model axis), on 2x1 and 1x2 meshes, on
tests/test_torch_scimm.py's EM case (the 2-genome fixture reads, a third
of their seeds scrambled):

* assignments, ``mip``, logged probs and scores BITWISE equal to the
  port's one-rank device EM;
* against the JAX package's sharded EM on a 2x1 mesh (its TPU branch run
  on the CPU, the Pallas walk in interpret mode, as in
  tests/test_torch_scimm.py): assignments and ``mip`` equal, logged probs
  within 8 f32 ulps (the trainer's ``log``, ROADMAP C).
"""

import numpy as np
import pytest

from glimmer_mg_tpu.pipeline import scimm as jsc
from glimmer_mg_torch.pipeline import scimm as tsc

from tests._torch_common import f32_ulps, mg_genomes_and_reads
from tests._torch_common import one_torch_thread  # noqa: F401
from tests.test_torch_mesh import (bits, jax_mesh, jax_tpu_branch, launch,
                                   same_on_every_rank)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def seeded():
    _genomes, reads, _truth = mg_genomes_and_reads()
    seqs = [s for _h, s in reads]
    init = np.array([i % 2 for i in range(len(seqs))], np.int32)
    init[::3] = 1 - init[::3]
    return seqs, init


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, seeded):
    seqs, init = seeded
    return launch(tmp_path_factory.mktemp("mesh_em"),
                  [{"name": "scimm", "meshes": [[2, 1], [1, 2]]}],
                  {"seqs": np.array(seqs), "init": init}, 2)


@pytest.fixture(scope="module")
def one_rank(seeded):
    seqs, init = seeded
    assign, icms, scores = tsc.scimm_cluster(seqs, init, 2, use_device=True,
                                             device="cpu")
    assert not np.array_equal(assign, init)  # the EM moved reads
    return (assign, np.stack([m.mip for m in icms]),
            np.stack([m.probs for m in icms]), scores)


@pytest.fixture(scope="module")
def jax_sharded(seeded):
    seqs, init = seeded
    with pytest.MonkeyPatch.context() as mp:
        jax_tpu_branch(mp)
        assign, icms, _s = jsc.scimm_cluster(seqs, init, 2, use_device=True,
                                             mesh=jax_mesh(2, 1))
    return (np.asarray(assign), np.stack([m.mip for m in icms]),
            np.stack([m.probs for m in icms]))


@pytest.mark.parametrize("data,model", [(2, 1), (1, 2)])
def test_sharded_em_bitwise_to_one_rank(ranks, one_rank, data, model):
    tag = f"scimm_{data}x{model}"
    got = same_on_every_rank(ranks, tag)
    assign, mip, probs, scores = one_rank
    assert np.array_equal(got[f"{tag}_assign"], assign)
    assert np.array_equal(got[f"{tag}_mip"], mip)
    assert np.array_equal(bits(got[f"{tag}_probs"]), bits(probs))
    assert np.array_equal(bits(got[f"{tag}_scores"]), bits(scores))


@pytest.mark.parametrize("data,model", [(2, 1), (1, 2)])
def test_sharded_em_matches_jax_sharded(ranks, jax_sharded, data, model):
    tag = f"scimm_{data}x{model}"
    got = ranks[0]
    j_assign, j_mip, j_probs = jax_sharded
    assert np.array_equal(got[f"{tag}_assign"], j_assign)
    assert np.array_equal(got[f"{tag}_mip"], j_mip)
    finite = j_probs > -3e38
    assert np.array_equal(finite, got[f"{tag}_probs"] > -3e38)
    assert f32_ulps(got[f"{tag}_probs"][finite], j_probs[finite]).max() <= 8
