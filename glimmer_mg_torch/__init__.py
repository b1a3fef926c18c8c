"""glimmer_mg_torch: PyTorch/CUDA port of glimmer_mg_tpu's per-read gene prediction and Phymm classification.

The JAX package ``glimmer_mg_tpu`` is the reference; this package imports
nothing of it. Its host layers are copies of the JAX package's JAX-free
modules, in the same layout: ``utils``, ``models``, ``io``,
``engine.orfs``, ``engine.events``, ``engine.glimmer3``, ``engine.mg_host``
(the host half of ``engine.glimmer_mg``), ``native`` (the C++ per-read
and glimmer3 engine, built with g++ into ``build/`` at first use) and
``pipeline.train_all`` with the training stages it runs. The device path
is the port's own:

  ops/icm_score.py      plain PyTorch ICM walks: the exact walk and the
                        twins of both kernels
  ops/icm_cuda.py       wrappers of the CUDA kernels csrc/six_frame.cu
                        and csrc/bank_walk.cu; bank-walk table packing
  ops/device_predict.py bank tables, batch entry point, host finish
  ops/frontend.py       ORF/start-candidate frontend and event assembly
  ops/event_dp.py       windowed event-graph DP and traceback (K3's twin)
  ops/event_dp_cuda.py  wrapper of the CUDA kernel csrc/event_dp.cu (K3)
  engine/glimmer_mg.py  run_glimmer_mg / run_glimmer_mg_classes
  parallel/classify.py  classification steps (both strands, per-read max),
                        on one rank or over a mesh
  parallel/phymm.py     PhymmBank, classify_file, Phymm file formats
  io/fasta_share.py     a rank's share of a FASTA file, read and encoded
  parallel/mesh.py      the (data, model) mesh of ranks on
                        torch.distributed and its sharding helpers
  parallel/predict.py   device prediction sharded over the data axis
  parallel/dryrun.py    every mesh path once over a world of ranks
  parallel/launch.py    a world of ranks started on this machine
  pipeline/glimmer_mg_pipe.py  run_pipeline, stages 1-3 (classify ->
                        parse classes -> predict)
  pipeline/accuracy.py  gene-level accuracy of the whole pipeline
  bench_db.py           the bench's synthetic DB, reads and sample-run
                        stand-in
  bench.py              python -m glimmer_mg_torch.bench, the JAX
                        bench's four metrics through the port's kernels

It imports ``torch`` and never ``jax``. Every entry point takes an
explicit ``device``.
"""

__version__ = "0.1.0"
