"""expecto_tpu_torch: the PyTorch/CUDA port of ExPecto-TPU for NVIDIA Hopper.

A second package beside ``expecto_tpu`` (the JAX reference, which it never
imports). It serves ``expecto-score`` — VCF rows to per-tissue expression
effects — on one CUDA GPU, with every Beluga convolution on a hand-written
kernel: ``csrc/conv8_relu_tc.cu`` (bf16 on the tensor cores, conv1-conv5)
or ``csrc/conv8_relu.cu`` (SIMT: fp32 and conv0), chosen in ops/conv8.py.

Subpackages mirror the JAX package's: ``genome``, ``io``, ``models``,
``ops``, ``parallel``, ``pipeline`` and ``cli``; ``csrc`` holds the CUDA
sources, built with ``nvcc`` on first use (ops/cuda_build.py).
"""

__version__ = "0.1.0"
