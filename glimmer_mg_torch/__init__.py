"""glimmer_mg_torch: PyTorch/CUDA port of glimmer_mg_tpu's per-read gene prediction.

The JAX package ``glimmer_mg_tpu`` is the reference. This package reuses
its JAX-free host layers (``models``, ``io``, ``engine.orfs``,
``engine.events``, ``engine.glimmer3``, the host half of
``engine.glimmer_mg``, ``pipeline.train_all``, ``utils``) and replaces the
device path:

  ops/icm_score.py      plain PyTorch six-frame ICM walk (the kernel's twin)
  ops/icm_cuda.py       wrapper of the CUDA kernel csrc/six_frame.cu
  ops/device_predict.py bank tables, batch entry point, host finish
  ops/frontend.py       ORF/start-candidate frontend and event assembly
  ops/event_dp.py       windowed event-graph DP and traceback
  engine/glimmer_mg.py  run_glimmer_mg / run_glimmer_mg_classes

It imports ``torch`` and never ``jax``. Every entry point takes an
explicit ``device``.
"""

__version__ = "0.1.0"
