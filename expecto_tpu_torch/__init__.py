"""expecto_tpu_torch: the PyTorch/CUDA port of ExPecto-TPU for NVIDIA Hopper.

A second package beside ``expecto_tpu`` (the JAX reference, which it never
imports). It serves ``expecto-score`` — VCF rows to per-tissue expression
effects — on one CUDA GPU, with every Beluga convolution on a hand-written
kernel: conv0 on ``csrc/conv0_codes.cu``; conv1-conv5 on
``csrc/conv8_relu_tc.cu`` (bf16 on the tensor cores) or
``csrc/conv8_relu_tf32x3.cu`` (fp32 on the TF32 tensor cores in three
passes), the rest on ``csrc/conv8_relu.cu`` (SIMT), chosen in ops/conv8.py.

Subpackages mirror the JAX package's: ``genome``, ``io``, ``models``,
``ops``, ``parallel``, ``pipeline`` and ``cli``; ``csrc`` holds the CUDA
sources, built with ``nvcc`` on first use (ops/cuda_build.py).
"""

__version__ = "0.1.0"
