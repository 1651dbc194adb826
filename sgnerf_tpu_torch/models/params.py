"""Aggregator weights carried between the JAX reference and the port.

Both sides hold the reference's tree {"block1": [{"w": (in, out), "b":
(out,)}, ...], "alpha_branch": [...], "color_branch": [...]}: the port keeps
the (in, out) layout of x @ w (no nn.Linear, whose weight is (out, in)), so
a checkpoint maps across without a transpose.
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
