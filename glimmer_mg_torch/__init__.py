"""glimmer_mg_torch: PyTorch/CUDA port of glimmer_mg_tpu's per-read gene prediction and Phymm classification.

The JAX package ``glimmer_mg_tpu`` is the reference. This package reuses
its JAX-free host layers (``models``, ``io``, ``engine.orfs``,
``engine.events``, ``engine.glimmer3``, the host half of
``engine.glimmer_mg``, ``pipeline.train_all``, ``utils``) and replaces the
device path:

  ops/icm_score.py      plain PyTorch ICM walks: the exact walk and the
                        twins of both kernels
  ops/icm_cuda.py       wrappers of the CUDA kernels csrc/six_frame.cu
                        and csrc/bank_walk.cu; bank-walk table packing
  ops/device_predict.py bank tables, batch entry point, host finish
  ops/frontend.py       ORF/start-candidate frontend and event assembly
  ops/event_dp.py       windowed event-graph DP and traceback
  engine/glimmer_mg.py  run_glimmer_mg / run_glimmer_mg_classes
  parallel/classify.py  classification steps (both strands, per-read max)
  parallel/phymm.py     PhymmBank, classify_file, Phymm file formats
  pipeline/glimmer_mg_pipe.py  run_pipeline, stages 1-3 (classify ->
                        parse classes -> predict)

It imports ``torch`` and never ``jax``. Every entry point takes an
explicit ``device``.
"""

__version__ = "0.1.0"
