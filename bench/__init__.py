"""The benchmark of the PyTorch/CUDA port (``repro_torch``): closed-loop
serving through its ``InferenceEngine`` on one card.  ``run.py`` runs one
cell of ``BENCHMARK.json``; everything a cell needs is data under
``configs/`` and ``traffic/``, and each per-layer metric is a reader under
``metrics/``.  Nothing here imports JAX or the JAX package."""
