"""K2: fused aggregator forward (PE -> block1 -> alpha -> K-reduction).

Counterpart of the forward of `sgnerf_tpu/ops/fused_agg.py:
fused_block1_alpha`. The CUDA kernel is `csrc/fused_agg.cu` (its header
says what bounds it and how it is laid out); `fused_block1_alpha_plain`
states the same function in PyTorch. The wrapper runs the plain version
only for tensors on the CPU; for CUDA tensors it launches the kernel or
raises. This slice is eval-only: the wrapper refuses CUDA inputs that
require grad (the backward, kernel K3, comes with training).

The kernel computes PE in the reference's interleaved layout against the
unpermuted block1 weights; the TPU kernel's frequency-major layout with
permuted W1 rows was a lane-layout device of that chip.
"""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from . import _cuda
from .pe import positional_encoding


def softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: logaddexp(x, 0)."""
    return x.clamp_min(0.0) + torch.log1p(torch.exp(-x.abs()))


def matmul(x: torch.Tensor, w: torch.Tensor, bf16: bool) -> torch.Tensor:
    """x @ w in f32; with bf16, both inputs rounded to bf16 first (f32
    accumulation, like jnp.dot(..., preferred_element_type=f32))."""
    if bf16:
        x = x.to(torch.bfloat16).to(torch.float32)
        w = w.to(torch.bfloat16).to(torch.float32)
    return x @ w


def fused_block1_alpha_plain(feat, d, w, block1: List[Dict[str, torch.Tensor]],
                             alpha_branch, *, K: int, nf: int, df: int,
                             bf16: bool):
    """Plain PyTorch K2: feat (M,K,F), d (M,K,Dd), w (M,K) ->
    (feat_agg (M,C), alpha (M,1))."""
    x = torch.cat([feat, positional_encoding(feat, nf),
                   positional_encoding(d, df)], dim=-1)
    h = x
    for layer in block1:
        h = F.leaky_relu(matmul(h, layer["w"], bf16) + layer["b"], 0.01)
    wa, ba = alpha_branch[0]["w"], alpha_branch[0]["b"]
    alpha = softplus((h * wa[:, 0]).sum(-1, keepdim=True) + ba - 1.0)
    z = torch.cat([h * w[..., None], alpha * w[..., None]], dim=-1).sum(1)
    C = h.shape[-1]
    return z[:, :C], z[:, C:]


def _check(feat, d, w, block1, alpha_branch, K):
    if feat.dim() != 3 or feat.shape[1] != K:
        raise ValueError(f"feat must be (M, K={K}, F), got {tuple(feat.shape)}")
    M = feat.shape[0]
    if d.dim() != 3 or d.shape[:2] != feat.shape[:2]:
        raise ValueError(f"d must be ({M}, {K}, Dd), got {tuple(d.shape)}")
    if tuple(w.shape) != (M, K):
        raise ValueError(f"w must be ({M}, {K}), got {tuple(w.shape)}")
    if len(alpha_branch) != 1:
        raise ValueError("the fused path needs a 1-layer alpha head")
    ts = [feat, d, w, alpha_branch[0]["w"], alpha_branch[0]["b"]] + \
        [t for layer in block1 for t in (layer["w"], layer["b"])]
    if any(t.dtype != torch.float32 for t in ts):
        raise ValueError("fused_block1_alpha takes float32 tensors only")
    return ts


def fused_block1_alpha(feat: torch.Tensor, d: torch.Tensor, w: torch.Tensor,
                       block1: List[Dict[str, torch.Tensor]],
                       alpha_branch: List[Dict[str, torch.Tensor]], *,
                       K: int, nf: int, df: int, bf16: bool):
    """feat (M,K,F) f32, d (M,K,Dd), w (M,K) weight*conf (0 = masked) ->
    (feat_agg (M,C), alpha (M,1)). `fused_block1_alpha.launches` counts
    kernel launches."""
    ts = _check(feat, d, w, block1, alpha_branch, K)
    if feat.device.type == "cpu":
        return fused_block1_alpha_plain(feat, d, w, block1, alpha_branch,
                                        K=K, nf=nf, df=df, bf16=bf16)
    if feat.device.type != "cuda" or any(t.device != feat.device for t in ts):
        raise ValueError("fused_block1_alpha: every tensor must lie on one "
                         "CUDA device (or all on the CPU)")
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise NotImplementedError(
            "fused_block1_alpha has no backward yet (kernel K3, ROADMAP "
            "queue 2); run it under torch.no_grad()/inference_mode()")
    M, _, Fd = feat.shape
    Dd = d.shape[-1]
    C = block1[0]["w"].shape[1]
    in0 = Fd + 2 * Fd * nf + 2 * Dd * df
    if block1[0]["w"].shape[0] != in0 or any(
            tuple(l_["w"].shape) != (C, C) for l_ in block1[1:]):
        raise ValueError(f"block1 must be ({in0},{C}) then ({C},{C}) layers")
    if C % 32 or not 32 <= C <= 256 or not 1 <= K <= 64:
        raise ValueError(f"kernel needs C % 32 == 0, C <= 256, K <= 64; "
                         f"got C={C} K={K}")
    Wall = torch.cat([l_["w"].reshape(-1) for l_ in block1])
    Ball = torch.cat([l_["b"].reshape(-1) for l_ in block1])
    wa = alpha_branch[0]["w"].reshape(-1).contiguous()
    ba = alpha_branch[0]["b"].reshape(-1).contiguous()
    feat, d, w = feat.contiguous(), d.contiguous(), w.contiguous()
    out = torch.empty((M, C + 1), dtype=torch.float32, device=feat.device)
    lib = _cuda.load("fused_agg")
    with torch.cuda.device(feat.device):
        err = lib.fused_block1_alpha(
            _cuda.ptr(feat), _cuda.ptr(d), _cuda.ptr(w), _cuda.ptr(Wall),
            _cuda.ptr(Ball), len(block1), _cuda.ptr(wa), _cuda.ptr(ba),
            M, K, Fd, nf, Dd, df, C, int(bf16), _cuda.ptr(out),
            _cuda.stream_of(feat))
    fused_block1_alpha.launches += 1
    _cuda.check(lib, err, "fused_block1_alpha")
    return out[:, :C], out[:, C:]


fused_block1_alpha.launches = 0
