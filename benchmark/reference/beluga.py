"""DeepSEA-Beluga in plain PyTorch, window by window: the yardstick's
forward pass (Zhou et al. 2018; FunctionLab/ExPecto Beluga.py: six width-8
convolutions 4-320-320-480-480-640-640 with ReLU, 4-wide max-pools after the
second and the fourth, a 67,840-2,003 dense layer with ReLU, a 2,003-2,002
dense layer and a sigmoid).

It reads the weights in the layout the benchmark draws them (conv (8, in,
out), fc1 over a length-major flatten) and imports nothing of the program.

``precision`` says how the arithmetic runs:

- ``"fp32"``: float32 with TF32 off in every convolution and product (the
  reference);
- ``"tf32"``: every product's operands rounded to TF32 (10 mantissa
  bits, to nearest, ties away, as the tensor cores' ``cvt.rna.tf32.f32``),
  summed in float32: TF32 on, emulated so that it reads the same on any
  device (the control of a float32 configuration);
- ``"fp8"``: every convolution's and dense layer's input and weight
  rounded to float8 e4m3 with a scale per tensor (its largest magnitude to
  448), products summed in float32 (the control of a bfloat16
  configuration).
"""

from __future__ import annotations

from contextlib import contextmanager

import torch
import torch.nn.functional as F

PRECISIONS = ("fp32", "tf32", "fp8")
E4M3_MAX = 448.0


@contextmanager
def precision_mode():
    """True float32 products (TF32 off) inside; restores the settings
    after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32: 13 low mantissa bits cleared, to
    nearest with ties away from zero."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def rounding(precision: str):
    """The operand rounding of ``precision``."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    return {"fp32": lambda t: t, "tf32": tf32_round, "fp8": fp8_round}[precision]


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale (largest |x| to 448),
    returned in float32."""
    amax = x.abs().amax()
    scale = torch.where(amax > 0, amax / E4M3_MAX, torch.ones_like(amax))
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Beluga:
    """The forward pass over (N, 2000) base codes (0-3 = A, G, C, T; any
    other code is N, the zero vector)."""

    def __init__(self, params: dict, precision: str = "fp32"):
        self.precision = precision
        q = rounding(precision)
        n_conv = sum(1 for k in params if k.startswith("conv"))
        # conv1d wants (out, in, width)
        self.convs = [(q(params[f"conv{i}"]["w"].float()).permute(2, 1, 0).contiguous(),
                       params[f"conv{i}"]["b"].float()) for i in range(n_conv)]
        self.fc1 = (q(params["fc1"]["w"].float()), params["fc1"]["b"].float())
        self.fc2 = (q(params["fc2"]["w"].float()), params["fc2"]["b"].float())
        self._q = q

    def logits(self, codes: torch.Tensor) -> torch.Tensor:
        """(N, L) codes -> (N, tracks) pre-sigmoid outputs."""
        q = self._q
        x = F.one_hot(codes.long().clamp(0, 4), 5)[..., :4].float().permute(0, 2, 1)
        for i, (w, b) in enumerate(self.convs):
            x = F.relu(F.conv1d(q(x), w, b))
            if i in (1, 3):
                x = F.max_pool1d(x, 4, 4)
        h = x.permute(0, 2, 1).reshape(x.shape[0], -1)  # length-major, as the weights are laid out
        h = F.relu(q(h) @ self.fc1[0] + self.fc1[1])
        return q(h) @ self.fc2[0] + self.fc2[1]

    def predict(self, codes: torch.Tensor) -> torch.Tensor:
        """(N, L) codes -> (N, tracks) sigmoid outputs, forward and reverse
        complement averaged (ExPecto's chromatin step)."""
        with precision_mode():
            fwd = torch.sigmoid(self.logits(codes))
            rc = torch.sigmoid(self.logits(reverse_complement(codes)))
        return (fwd + rc) * 0.5


def reverse_complement(codes: torch.Tensor) -> torch.Tensor:
    """Codes in AGCT order: the complement is 3 - code (N stays N), the
    sequence reversed."""
    comp = torch.where(codes < 4, 3 - codes, codes)
    return comp.flip(-1)
