"""Beluga weights: the npz checkpoint of expecto_tpu/models/convert.py.

The npz holds ``"<layer>/<name>"`` arrays in the JAX package's layout: conv
kernels WIO ``(8, in, out)``, ``fc1/w`` length-major ``(67840, 2003)``,
dense matrices ``(in, out)``. The port reads the same files and keeps the
same layout in its tensors (models/beluga.py).
"""

from __future__ import annotations

import os

import numpy as np
import torch


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
