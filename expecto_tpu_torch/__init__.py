"""expecto_tpu_torch: the PyTorch/CUDA port of ExPecto-TPU for NVIDIA Hopper.

A second package beside ``expecto_tpu`` (the JAX reference, which it never
imports). It serves ``expecto-score`` — VCF rows to per-tissue expression
effects — on one CUDA GPU, with every Beluga convolution on the
hand-written kernel ``csrc/conv8_relu.cu``.

Subpackages mirror the JAX package's: ``genome``, ``io``, ``models``,
``ops``, ``parallel``, ``pipeline`` and ``cli``; ``csrc`` holds the CUDA
sources, built with ``nvcc`` on first use (ops/cuda_build.py).
"""

__version__ = "0.1.0"
