"""Beluga weights: the npz checkpoint and the converter from the published
torch checkpoint (port of expecto_tpu/models/convert.py).

The production weights ship as a torch ``state_dict``
(``deepsea.beluga.pth``, reference chromatin.py:103). The converter maps
them to the npz layout every CLI of this package reads:

    - conv kernels: torch OIHW ``(out, in, 1, 8)`` -> WIO ``(8, in, out)``;
    - dense 1: the torch flatten is channel-major (``x.view(N, -1)`` on
      ``(N, 640, 1, 106)``, Beluga.py:42), this package's is length-major on
      ``(N, 106, 640)``, so the input axis of W1 is permuted
      (``new[l*640 + c] = old[c*106 + l]``) and the runtime does a straight
      reshape;
    - dense matrices are transposed to ``(in, out)``.

The npz holds ``"<layer>/<name>"`` arrays: conv kernels WIO, ``fc1/w``
length-major ``(67840, 2003)``, dense matrices ``(in, out)``. Conversion is
a file transform on the host::

    python -m expecto_tpu_torch.models.convert deepsea.beluga.pth beluga.npz
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .beluga import CONV_SPECS, FC1_IN, FC1_OUT, FC2_OUT

# torch state_dict keys of the six convs and two linears, in model order
# (nested nn.Sequential indices; see reference Beluga.py:21-47).
TORCH_CONV_KEYS = ["model.0.0", "model.0.2", "model.0.6", "model.0.8", "model.0.12", "model.0.14"]
TORCH_FC_KEYS = ["model.1.2.1", "model.1.4.1"]

_N_CHANNELS_FLAT = 640
_LEN_FLAT = 106


def fc1_permutation() -> np.ndarray:
    """perm[l*640 + c] = c*106 + l (channel-major -> length-major)."""
    l_idx, c_idx = np.meshgrid(np.arange(_LEN_FLAT), np.arange(_N_CHANNELS_FLAT), indexing="ij")
    return (c_idx * _LEN_FLAT + l_idx).reshape(-1)


def state_dict_to_params(state_dict: dict) -> dict:
    """Map a torch Beluga state_dict (tensors or numpy arrays) to the npz
    layout. Returns numpy float32 arrays."""

    def arr(v):
        return np.asarray(v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v, dtype=np.float32)

    params: dict = {}
    for i, (key, (w, cin, cout)) in enumerate(zip(TORCH_CONV_KEYS, CONV_SPECS)):
        kernel = arr(state_dict[key + ".weight"])  # (out, in, 1, 8)
        if kernel.shape != (cout, cin, 1, w):
            raise ValueError(f"conv{i} weight shape {kernel.shape}, expected {(cout, cin, 1, w)}")
        params[f"conv{i}"] = {
            "w": np.ascontiguousarray(kernel[:, :, 0, :].transpose(2, 1, 0)),  # WIO
            "b": arr(state_dict[key + ".bias"]),
        }

    w1 = arr(state_dict[TORCH_FC_KEYS[0] + ".weight"])  # (2003, 67840) channel-major inputs
    if w1.shape != (FC1_OUT, FC1_IN):
        raise ValueError(f"fc1 weight shape {w1.shape}, expected {(FC1_OUT, FC1_IN)}")
    # (67840, 2003) length-major: w1[:, fc1_permutation()].T, taken as one
    # strided copy (the channel-major input axis is (640, 106))
    fc1 = np.ascontiguousarray(w1.reshape(FC1_OUT, _N_CHANNELS_FLAT, _LEN_FLAT).transpose(2, 1, 0))
    params["fc1"] = {"w": fc1.reshape(FC1_IN, FC1_OUT), "b": arr(state_dict[TORCH_FC_KEYS[0] + ".bias"])}
    w2 = arr(state_dict[TORCH_FC_KEYS[1] + ".weight"])  # (2002, 2003)
    if w2.shape != (FC2_OUT, FC1_OUT):
        raise ValueError(f"fc2 weight shape {w2.shape}, expected {(FC2_OUT, FC1_OUT)}")
    params["fc2"] = {"w": np.ascontiguousarray(w2.T), "b": arr(state_dict[TORCH_FC_KEYS[1] + ".bias"])}
    return params


def save_params_npz(params: dict, path: str | os.PathLike) -> None:
    """Write a params pytree (numpy arrays or tensors) as the npz checkpoint."""
    flat = {}
    for layer, d in params.items():
        for name, a in d.items():
            flat[f"{layer}/{name}"] = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.savez(path, **flat)


def load_params_npz(path: str | os.PathLike) -> dict:
    """npz checkpoint -> {layer: {name: numpy array}} (the JAX package's pytree)."""
    with np.load(path) as flat:
        params: dict = {}
        for key in flat.files:
            layer, name = key.split("/")
            params.setdefault(layer, {})[name] = flat[key]
    return params


def params_from_jax(params_np: dict, *, device="cpu", dtype=torch.float32) -> dict[str, dict[str, torch.Tensor]]:
    """The JAX package's Beluga pytree (numpy, array-like or tensor leaves)
    as tensors of the port on ``device`` in ``dtype``: same keys, shapes and
    layout."""

    def leaf(a):
        t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
        return t.to(device=device, dtype=dtype).contiguous()

    return {layer: {name: leaf(a) for name, a in d.items()} for layer, d in params_np.items()}


def convert_torch_checkpoint(pth_path: str | os.PathLike, npz_path: str | os.PathLike) -> None:
    """CLI entry: ``python -m expecto_tpu_torch.models.convert in.pth out.npz``."""
    state_dict = torch.load(pth_path, map_location="cpu", weights_only=True)
    save_params_npz(state_dict_to_params(state_dict), npz_path)


if __name__ == "__main__":
    import sys

    convert_torch_checkpoint(sys.argv[1], sys.argv[2])
