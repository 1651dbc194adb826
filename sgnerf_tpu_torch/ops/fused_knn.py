"""K1: fused KNN select over gathered merged-neighbourhood cache rows.

Counterpart of `sgnerf_tpu/ops/fused_knn.py:fused_knn_select`. The CUDA
kernel is `csrc/fused_knn.cu` (its header says what bounds it and how it is
laid out); `fused_knn_select_plain` states the same function in PyTorch.
The wrapper runs the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.

Semantics (the reference's exact cache path): smallest d2 first, ties by
candidate index, invalid candidates and exhausted rounds -> -1. Ids are
integers: there is no gradient.
"""
from __future__ import annotations

import ctypes

import torch

from . import _cuda

_BIG = torch.finfo(torch.float32).max


def _check(rows, delta, ok, C, K):
    M = rows.shape[0]
    if rows.dtype != torch.int16 or rows.dim() != 2 or rows.shape[1] != 5 * C:
        raise ValueError(f"rows must be (M, 5*C={5 * C}) int16, got "
                         f"{tuple(rows.shape)} {rows.dtype}")
    if delta.dtype != torch.float32 or tuple(delta.shape) != (M, 3):
        raise ValueError(f"delta must be ({M}, 3) float32, got "
                         f"{tuple(delta.shape)} {delta.dtype}")
    if ok.dtype != torch.bool or tuple(ok.shape) != (M,):
        raise ValueError(f"ok must be ({M},) bool, got {tuple(ok.shape)} "
                         f"{ok.dtype}")
    if not 1 <= K <= C <= 64:
        raise ValueError(f"need 1 <= K <= C <= 64, got K={K} C={C}")


def fused_knn_select_plain(rows: torch.Tensor, delta: torch.Tensor,
                           ok: torch.Tensor, radius2, *, C: int,
                           K: int) -> torch.Tensor:
    """Plain PyTorch K1: (M,5C) int16 rows, (M,3) delta, (M,) ok,
    scalar r2 (0 disables) -> (M,K) int32 ids."""
    def bf16_plane(i):
        return rows[:, i * C:(i + 1) * C].contiguous().view(
            torch.bfloat16).to(torch.float32)
    lo = rows[:, 3 * C:4 * C].to(torch.int32) & 0xFFFF
    hi = rows[:, 4 * C:5 * C].to(torch.int32)
    pidx = (hi << 16) | lo
    dx = bf16_plane(0) - delta[:, 0:1]
    dy = bf16_plane(1) - delta[:, 1:2]
    dz = bf16_plane(2) - delta[:, 2:3]
    d2 = dx * dx + dy * dy + dz * dz
    r2 = torch.as_tensor(radius2, dtype=torch.float32, device=rows.device)
    valid = (pidx >= 0) & ok[:, None] & ((d2 <= r2) | (r2 <= 0))
    d2 = torch.where(valid, d2, torch.full_like(d2, _BIG))
    d2s, idx = torch.sort(d2, dim=-1, stable=True)
    sel = torch.gather(pidx, 1, idx[:, :K])
    return torch.where(d2s[:, :K] < _BIG, sel, torch.full_like(sel, -1))


def fused_knn_select(rows: torch.Tensor, delta: torch.Tensor,
                     ok: torch.Tensor, radius2, *, C: int,
                     K: int) -> torch.Tensor:
    """(M,5C) int16 planar rows, (M,3) f32 loc - voxel centre, (M,) bool
    slot validity, scalar r2 (0 disables) -> (M,K) int32 ids (-1 invalid).
    `fused_knn_select.launches` counts kernel launches."""
    _check(rows, delta, ok, C, K)
    if rows.device.type == "cpu":
        return fused_knn_select_plain(rows, delta, ok, radius2, C=C, K=K)
    if rows.device.type != "cuda" or {delta.device, ok.device} != {rows.device}:
        raise ValueError("fused_knn_select: rows, delta and ok must share "
                         "one CUDA device (or all lie on the CPU)")
    rows, delta = rows.contiguous(), delta.contiguous()
    ok = ok.contiguous().view(torch.uint8)
    M = rows.shape[0]
    out = torch.empty((M, K), dtype=torch.int32, device=rows.device)
    lib = _cuda.load("fused_knn")
    with torch.cuda.device(rows.device):
        err = lib.fused_knn_select(
            _cuda.ptr(rows), _cuda.ptr(delta), _cuda.ptr(ok),
            ctypes.c_float(float(radius2)), ctypes.c_int(M), ctypes.c_int(C),
            ctypes.c_int(K), _cuda.ptr(out), _cuda.stream_of(rows))
    fused_knn_select.launches += 1
    _cuda.check(lib, err, "fused_knn_select")
    return out


fused_knn_select.launches = 0
