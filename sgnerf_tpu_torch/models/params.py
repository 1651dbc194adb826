"""Aggregator weights carried between the JAX reference and the port.

Both sides hold the reference's tree {"block1": [{"w": (in, out), "b":
(out,)}, ...], "alpha_branch": [...], "color_branch": [...]}: the port keeps
the (in, out) layout of x @ w (no nn.Linear, whose weight is (out, in)), so
a checkpoint maps across without a transpose. BPNet's tree crosses with
its 2D conv weights transposed (`bpnet_params_from_jax`), the MVS nets'
with their 2D and 3D conv weights transposed (`mvs_params_from_jax`).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def params_from_jax(tree: Dict[str, Any], device="cpu") -> Dict[str, Any]:
    """Reference param tree held as numpy -> float32 tensors on `device`."""
    return {block: [{k: torch.tensor(np.asarray(v, np.float32), device=device)
                     for k, v in layer.items()} for layer in layers]
            for block, layers in tree.items()}


def params_to_jax(params: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of params_from_jax: numpy arrays the reference can load."""
    return {block: [{k: v.detach().cpu().numpy() for k, v in layer.items()}
                    for layer in layers]
            for block, layers in params.items()}


def bpnet_params_from_jax(tree: Any, device="cpu") -> Any:
    """The JAX BPNet tree held as numpy -> the port's: float32 tensors on
    `device`, 2D conv weights HWIO -> (co, ci, kh, kw); the sparse (K^3, ci,
    co) weights and BN statistics as they are. Non-array leaves (the JAX
    linkers' `fea2d_dim`) are dropped."""
    if isinstance(tree, dict):
        out = {k: bpnet_params_from_jax(v, device) for k, v in tree.items()}
        return {k: v for k, v in out.items() if v is not None}
    if isinstance(tree, (list, tuple)):
        return [bpnet_params_from_jax(v, device) for v in tree]
    if not hasattr(tree, "shape"):
        return None
    a = np.asarray(tree, np.float32)
    if a.ndim == 4:
        a = a.transpose(3, 2, 0, 1)
    return torch.tensor(np.ascontiguousarray(a), device=device)


def bpnet_params_to_jax(tree: Any) -> Any:
    """Inverse of bpnet_params_from_jax: numpy arrays, 2D convs HWIO."""
    if isinstance(tree, dict):
        return {k: bpnet_params_to_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [bpnet_params_to_jax(v) for v in tree]
    a = tree.detach().cpu().numpy()
    return np.ascontiguousarray(a.transpose(2, 3, 1, 0)) if a.ndim == 4 \
        else a


def mvs_params_from_jax(tree: Any, device="cpu") -> Any:
    """The JAX MVS tree {FeatureNet, CostRegNet, official, premlp} (numpy
    or jax leaves) -> the port's: float32 tensors on `device`, 2D conv
    weights HWIO -> OIHW, 3D DHWIO -> OIDHW. The transposed 3D convs take
    the same permutation: JAX holds them as (kd,kh,kw,co,ci) for its
    transpose_kernel form, which becomes ConvTranspose3d's (ci,co,kd,kh,kw).
    premlp's (in, out) and the BN leaves (statistics included) cross as
    they are."""
    if isinstance(tree, dict):
        return {k: mvs_params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [mvs_params_from_jax(v, device) for v in tree]
    a = np.asarray(tree, np.float32)
    if a.ndim == 4:
        a = a.transpose(3, 2, 0, 1)
    elif a.ndim == 5:
        a = a.transpose(4, 3, 0, 1, 2)
    return torch.tensor(np.ascontiguousarray(a), device=device)


def mvs_params_to_jax(tree: Any) -> Any:
    """Inverse of mvs_params_from_jax: numpy arrays in the JAX layout."""
    if isinstance(tree, dict):
        return {k: mvs_params_to_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [mvs_params_to_jax(v) for v in tree]
    a = tree.detach().cpu().numpy()
    if a.ndim == 4:
        a = a.transpose(2, 3, 1, 0)
    elif a.ndim == 5:
        a = a.transpose(2, 3, 4, 1, 0)
    return np.ascontiguousarray(a)
