"""The benchmark of the PyTorch and CUDA port (``expecto_tpu_torch``):
``python3 -m benchmark.run`` runs one cell of ``BENCHMARK.json``. Nothing in
this package imports JAX or the JAX package."""
