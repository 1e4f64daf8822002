"""DeepSEA-Beluga chromatin CNN in PyTorch (port of expecto_tpu/models/beluga.py).

Architecture (reference Beluga.py:18-51): six valid 1-D convolutions of width
8 in three blocks with 4-wide max-pools between blocks, then two dense layers:

    (N, 2000, 4 one-hot) or (N, 2000) int8 base codes
    -> conv 4->320 -> ReLU -> conv 320->320 -> ReLU -> pool4   (N, 496, 320)
    -> conv 320->480 -> ReLU -> conv 480->480 -> ReLU -> pool4 (N, 120, 480)
    -> conv 480->640 -> ReLU -> conv 640->640 -> ReLU          (N, 106, 640)
    -> flatten 67,840 -> dense 2003 -> ReLU -> dense 2002 -> sigmoid

Layouts are the JAX package's: channels-last (N, L, C) activations, WIO
``(8, in, out)`` conv kernels and a length-major flatten, so the npz weights
of models/convert.py load unchanged. Every conv runs on a hand-written CUDA
kernel on the card: conv0 over int8 base codes on
:func:`expecto_tpu_torch.ops.conv0.conv0_codes_relu` (no float one-hot is
built), conv0 over a one-hot, conv2, conv4 and conv5 on
:func:`expecto_tpu_torch.ops.conv8.conv8_relu`, and conv1 and conv3 with
the max-pool after them fused into the kernel's epilogue on
:func:`expecto_tpu_torch.ops.conv8.conv8_relu_pool4`. Parameters are a plain dict
``{"conv{i}": {"w", "b"}, "fc1": {"w", "b"}, "fc2": {"w", "b"}}`` of tensors.
"""

from __future__ import annotations

import math

import torch

from ..ops.conv0 import conv0_codes_relu
from ..ops.conv8 import conv8_relu, conv8_relu_pool4

BELUGA_INPUT_LEN = 2000
BELUGA_N_TRACKS = 2002

#: (width, in_ch, out_ch) for the six convolutions.
CONV_SPECS = [(8, 4, 320), (8, 320, 320), (8, 320, 480), (8, 480, 480), (8, 480, 640), (8, 640, 640)]
FC1_IN = 640 * 106  # 67,840
FC1_OUT = 2003
FC2_OUT = BELUGA_N_TRACKS

BelugaParams = dict[str, dict[str, torch.Tensor]]


def init_beluga_params(generator: torch.Generator, dtype=torch.float32, device=None) -> BelugaParams:
    """He-style random init (for tests and benchmarks; production weights come
    from the converted DeepSEA checkpoint, see convert.py): each weight drawn
    from N(0, 2 / fan_in) with ``generator``, on its device, biases zero.
    The same generator state gives the same tensors; no torch generator
    gives ``jax.random``'s numbers. ``device`` defaults to the generator's."""
    device = generator.device if device is None else torch.device(device)

    def layer(shape, fan_in: int, n_out: int) -> dict:
        w = torch.randn(shape, generator=generator, device=generator.device) * math.sqrt(2.0 / fan_in)
        return {"w": w.to(device=device, dtype=dtype), "b": torch.zeros(n_out, dtype=dtype, device=device)}

    params = {f"conv{i}": layer((w, cin, cout), w * cin, cout) for i, (w, cin, cout) in enumerate(CONV_SPECS)}
    params["fc1"] = layer((FC1_IN, FC1_OUT), FC1_IN, FC1_OUT)
    params["fc2"] = layer((FC1_OUT, FC2_OUT), FC1_OUT, FC2_OUT)
    return params


def count_params(params: BelugaParams) -> int:
    """Number of scalars in a Beluga pytree (tensors or numpy arrays)."""
    return sum(math.prod(a.shape) for layer in params.values() for a in layer.values())


def _conv_relu(x: torch.Tensor, p: dict) -> torch.Tensor:
    return conv8_relu(x.contiguous(), p["w"], p["b"])


def _conv_relu_pool4(x: torch.Tensor, p: dict, phases) -> dict[int, torch.Tensor]:
    """The conv, then the 4-wide max-pool from each of ``phases``, in one
    launch: {phase: (N, (L-7-phase)//4, Cout)}, each contiguous and aligned,
    so the next conv takes it as it is."""
    return conv8_relu_pool4(x.contiguous(), p["w"], p["b"], phases)


def _conv0(x: torch.Tensor, p: dict) -> torch.Tensor:
    """conv0 of (N, L) integer base codes on the code-gather kernel, or of an
    (N, L, 4) one-hot on conv8_relu."""
    if x.dim() == 2 and not x.is_floating_point():
        return conv0_codes_relu(x, p["w"], p["b"])
    return _conv_relu(x, p)


def beluga_forward(params: BelugaParams, x: torch.Tensor, *, logits: bool = False) -> torch.Tensor:
    """Forward pass: (N, 2000, 4) one-hot -> (N, 2002) track probabilities.

    ``x`` may also be (N, 2000) int8 base codes, the one-hot's codes (every
    code outside 0..3, N among them, adds nothing), as the serving runner
    passes it. ``logits=True`` skips the output sigmoid."""
    h = _conv0(x, params["conv0"])
    h = _conv_relu_pool4(h, params["conv1"], (0,))[0]  # torch MaxPool2d((1,4),(1,4)): floor mode
    h = _conv_relu(h, params["conv2"])
    h = _conv_relu_pool4(h, params["conv3"], (0,))[0]
    h = _conv_relu(h, params["conv4"])
    h = _conv_relu(h, params["conv5"])
    h = h.reshape(h.shape[0], -1)  # length-major flatten
    h = torch.relu(h @ params["fc1"]["w"] + params["fc1"]["b"])
    out = h @ params["fc2"]["w"] + params["fc2"]["b"]
    return out if logits else torch.sigmoid(out)
