"""K1 and K6: fused KNN select over gathered merged-neighbourhood cache
rows, per shading point (K1) or from per-tile distinct rows (K6).

Counterpart of `sgnerf_tpu/ops/fused_knn.py` `fused_knn_select`,
`tile_unique` and `fused_knn_select_tiled`. Both kernels are in
`csrc/fused_knn.cu` (its header says what bounds them and how they are laid
out); `fused_knn_select_plain` and `fused_knn_select_tiled_plain` state the
same functions in PyTorch. The wrappers run the plain versions only for
tensors on the CPU; for CUDA tensors they launch the kernels or raise.

Semantics (the reference's exact cache path): smallest d2 first, ties by
candidate index, invalid candidates and exhausted rounds -> -1. Ids are
integers: there is no gradient.

The kernels' select: 8 lanes a shading point, lane g on the candidates
g*N .. g*N+N-1 (N = ceil(C/8)), each lane's keys sorted in registers, then
K rounds that take the smallest head of the 8 lanes (ties to the lowest
lane) and pop it; `tests/test_torch_knn_select_model.py` states it step for
step. K6 runs on a persistent grid that the C entry works out from the
card's occupancy: one contiguous range of points a block, each tile the
range touches staged in shared memory once.
"""
from __future__ import annotations

import ctypes

import torch

from . import _cuda

_BIG = torch.finfo(torch.float32).max
_INVALID_VALUE = 1       # cudaErrorInvalidValue


def _check(rows, delta, ok, C, K, M=None):
    """Types and shapes of a select's inputs; M points (default: one row
    each)."""
    M = rows.shape[0] if M is None else M
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


def fused_knn_resources(C: int, U: int, device=None):
    """Registers a thread, shared memory a block (bytes) and resident blocks
    an SM on the card of K1 and of K6 (U rows a tile) at C candidates."""
    lib = _cuda.load("fused_knn")
    vals = [(ctypes.c_int * 2)() for _ in range(3)]
    with torch.cuda.device(device):
        err = lib.fused_knn_occupancy(C, U, *vals)
    _cuda.check(lib, err, "fused_knn_occupancy")
    keys = ("registers", "smem_bytes", "blocks_per_sm")
    return {k: dict(zip(keys, (v[i] for v in vals)))
            for i, k in enumerate(("K1", "K6"))}


def tile_unique(slot: torch.Tensor, ok: torch.Tensor, T: int, U: int):
    """Per-tile distinct cache slots (the JAX package's `tile_unique`, bit
    for bit). slot (M,) int32, ok (M,) bool, M a multiple of T; a tile is T
    consecutive rows. Returns (uniq (M//T, U) int32: the U smallest distinct
    valid slots of each tile, -1 padded; inv (M,) int32: each row's index in
    its tile's uniq, U when the row is invalid or its slot ranks past U)."""
    M = slot.shape[0]
    if M % T:
        raise ValueError(f"M = {M} must be a multiple of T = {T}")
    nt = M // T
    big = 2 ** 30
    s = torch.where(ok, slot.to(torch.int32),
                    torch.full_like(slot, big, dtype=torch.int32))
    sv, sp = torch.sort(s.reshape(nt, T), dim=-1, stable=True)
    first = torch.ones_like(sv, dtype=torch.bool)
    first[:, 1:] = sv[:, 1:] != sv[:, :-1]
    rank = torch.cumsum(first.to(torch.int32), dim=-1) - 1
    ranku = torch.where((sv < big) & (rank < U), rank,
                        torch.full_like(rank, U)).long()
    vals = torch.where(ranku < U, sv, torch.full_like(sv, -1))
    # per-segment max over (tile, rank); the extra rank-U column collects
    # the invalid rows and is dropped
    uniq = torch.full((nt, U + 1), -1, dtype=torch.int32, device=slot.device)
    uniq.scatter_reduce_(1, ranku, vals, reduce="amax")
    # ranks back in row order: sp is a permutation of each tile's rows
    inv = torch.empty_like(ranku).scatter_(1, sp, ranku)
    return uniq[:, :U], inv.reshape(-1).to(torch.int32)


def _check_tiled(rows, inv, delta, ok, C, K, T, U):
    M = inv.shape[0]
    if inv.dtype != torch.int32 or inv.dim() != 1 or M % T:
        raise ValueError(f"inv must be (nt*T,) int32 with T = {T}, got "
                         f"{tuple(inv.shape)} {inv.dtype}")
    if tuple(rows.shape[:1]) != (M // T * U,):
        raise ValueError(f"rows must hold U = {U} rows per tile: "
                         f"{M // T * U}, got {rows.shape[0]}")
    _check(rows, delta, ok, C, K, M)


def fused_knn_select_tiled_plain(rows, inv, delta, ok, radius2, *, C: int,
                                 K: int, T: int, U: int) -> torch.Tensor:
    """Plain K6: K1 on row inv[m] of point m's tile (inv == U: no row, every
    candidate rejected) -> (nt*T, K) int32 ids."""
    M = inv.shape[0]
    tile = torch.arange(M, device=inv.device) // T
    r = tile * U + inv.clamp(max=U - 1).long()
    return fused_knn_select_plain(rows[r], delta, ok & (inv < U), radius2,
                                  C=C, K=K)


def fused_knn_select_tiled(rows: torch.Tensor, inv: torch.Tensor,
                           delta: torch.Tensor, ok: torch.Tensor, radius2, *,
                           C: int, K: int, T: int, U: int) -> torch.Tensor:
    """K6: (nt*U, 5C) int16 rows, U per tile of T consecutive points (from
    `tile_unique`), (nt*T,) int32 inv in [0, U], (nt*T, 3) f32 delta,
    (nt*T,) bool ok, scalar r2 (0 disables) -> (nt*T, K) int32 ids (-1
    invalid). Equal to K1 on each point's own row wherever its tile did not
    overflow U. `fused_knn_select_tiled.launches` counts kernel launches."""
    _check_tiled(rows, inv, delta, ok, C, K, T, U)
    if rows.device.type == "cpu":
        return fused_knn_select_tiled_plain(rows, inv, delta, ok, radius2,
                                            C=C, K=K, T=T, U=U)
    if rows.device.type != "cuda" or {inv.device, delta.device,
                                      ok.device} != {rows.device}:
        raise ValueError("fused_knn_select_tiled: rows, inv, delta and ok "
                         "must share one CUDA device (or all lie on the CPU)")
    rows, inv, delta = rows.contiguous(), inv.contiguous(), delta.contiguous()
    ok = ok.contiguous().view(torch.uint8)
    M = inv.shape[0]
    out = torch.empty((M, K), dtype=torch.int32, device=rows.device)
    lib = _cuda.load("fused_knn")
    with torch.cuda.device(rows.device):
        err = lib.fused_knn_select_tiled(
            _cuda.ptr(rows), _cuda.ptr(inv), _cuda.ptr(delta), _cuda.ptr(ok),
            ctypes.c_float(float(radius2)), M // T, T, U, C, K,
            _cuda.ptr(out), _cuda.stream_of(rows))
    if err == _INVALID_VALUE:               # refused before any launch
        raise ValueError(f"fused_knn_select_tiled: U={U} rows of C={C} "
                         f"candidates (U * 10 C bytes) exceed a block's "
                         f"shared memory, or M={M} is past int32")
    fused_knn_select_tiled.launches += 1
    _cuda.check(lib, err, "fused_knn_select_tiled")
    return out


fused_knn_select_tiled.launches = 0
