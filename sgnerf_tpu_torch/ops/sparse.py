"""Sparse 3D convolution by gathered voxel rows (BPNet's MinkUNet18A and
Linking modules).

Counterpart of `sgnerf_tpu/ops/sparse.py` (the reference runs
MinkowskiEngine):
  * a `SparseGrid` holds voxel coords (M,3), features (M,C), a validity mask
    (capacity padding) and a dense coord->row lookup over the grid's box;
  * stride-1 conv: gather the K^3 neighbours' rows, (M,K^3*Ci) @
    (K^3*Ci,Co) with an f32 accumulator, the output in the weight's dtype;
  * stride-2 down conv (kernel 2): the coarse rows are the unique parents
    (coords >> 1) in ascending linear index, capacity-padded, each
    gathering its 2^3 children;
  * stride-2 transpose conv (kernel 2): each fine voxel reads its parent
    with the tap its coordinate parity selects.

The integer outputs (coarse coords, masks, lookups, gathered rows) equal
the JAX package's bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

INT32_MAX = 2 ** 31 - 1


@dataclasses.dataclass
class SparseGrid:
    coords: torch.Tensor   # (M,3) int32 voxel coords at this stride level
    feats: torch.Tensor    # (M,C)
    mask: torch.Tensor     # (M,) bool, live rows
    lookup: torch.Tensor   # (X*Y*Z,) int32 coord -> row, -1 empty
    dims: Tuple[int, int, int]

    @property
    def M(self) -> int:
        return self.coords.shape[0]


def _linear(coords: torch.Tensor, dims) -> torch.Tensor:
    c = coords.long()
    return c[..., 0] * (dims[1] * dims[2]) + c[..., 1] * dims[2] + c[..., 2]


def make_sparse_grid(coords: torch.Tensor, feats: torch.Tensor, dims,
                     mask: Optional[torch.Tensor] = None) -> SparseGrid:
    """coords int (M,3) in [0, dims); rows with mask False are padding and
    stay out of the lookup."""
    M = coords.shape[0]
    dev = coords.device
    if mask is None:
        mask = torch.ones(M, dtype=torch.bool, device=dev)
    dims = tuple(int(d) for d in dims)
    nvox = int(np.prod(dims))
    lin = torch.where(mask, _linear(coords, dims),
                      torch.full((M,), nvox, dtype=torch.long, device=dev))
    # one spare slot takes the padding rows, then is sliced off
    lookup = torch.full((nvox + 1,), -1, dtype=torch.int32, device=dev)
    lookup[lin] = torch.arange(M, dtype=torch.int32, device=dev)
    return SparseGrid(coords=coords.to(torch.int32), feats=feats, mask=mask,
                      lookup=lookup[:nvox], dims=dims)


def _offsets(k: int) -> np.ndarray:
    """Kernel offsets for odd k (centred) or k = 2 ({0,1}^3), the last axis
    fastest (meshgrid "ij")."""
    r = np.arange(k) - k // 2 if k % 2 == 1 else np.arange(k)
    g = np.stack(np.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
    return g.astype(np.int32)


def _gather_rows(grid: SparseGrid, coords: torch.Tensor):
    """coords (...,3) -> (row (...,) int32, -1 outside the grid, valid)."""
    dims = torch.tensor(grid.dims, dtype=torch.int32, device=coords.device)
    inb = ((coords >= 0) & (coords < dims)).all(dim=-1)
    lin = _linear(coords, grid.dims).clamp(0, grid.lookup.shape[0] - 1)
    row = torch.where(inb, grid.lookup[lin],
                      torch.full_like(lin, -1, dtype=torch.int32))
    return row, row >= 0


def _take_rows(feats: torch.Tensor, row: torch.Tensor, ok: torch.Tensor):
    """feats[row], zeros where not ok: invalid rows read an appended zero
    row (one gather, no masking pass over the gathered block)."""
    M = feats.shape[0]
    z = torch.cat([feats, feats.new_zeros((1,) + feats.shape[1:])])
    return z[torch.where(ok, row.long(), torch.full_like(row, M,
                                                         dtype=torch.long))]


def _contract(f: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """einsum("mkc,kcd->md") as one product: (M, K*Ci) @ (K*Ci, Co), in the
    weight's dtype (bf16 products accumulate in f32)."""
    M = f.shape[0]
    return f.reshape(M, -1).to(weight.dtype) @ weight.reshape(
        -1, weight.shape[-1])


def sparse_conv(grid: SparseGrid, weight: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                kernel_size: int = 3) -> torch.Tensor:
    """Stride-1 sparse conv on the grid's own coords. weight (K^3,Ci,Co);
    returns (M,Co)."""
    offs = torch.as_tensor(_offsets(kernel_size), device=grid.coords.device)
    row, ok = _gather_rows(grid, grid.coords[:, None, :] + offs)
    out = _contract(_take_rows(grid.feats, row, ok), weight)
    if bias is not None:
        out = out + bias
    return out * grid.mask[:, None].to(out.dtype)


def sparse_conv_down(grid: SparseGrid, weight: torch.Tensor,
                     out_capacity: int,
                     bias: Optional[torch.Tensor] = None
                     ) -> Tuple[SparseGrid, torch.Tensor]:
    """Kernel-2 stride-2 down conv: the coarse SparseGrid (coords =
    unique(coords >> 1) in ascending linear index, padded to out_capacity,
    parents past it dropped) and its features. weight (8,Ci,Co)."""
    dev = grid.coords.device
    cap = int(out_capacity)
    parent = torch.where(grid.mask[:, None], grid.coords >> 1,
                         torch.zeros_like(grid.coords))
    pdims = tuple((d + 1) // 2 for d in grid.dims)
    plin = torch.where(grid.mask, _linear(parent, pdims),
                       torch.full_like(grid.mask, INT32_MAX,
                                       dtype=torch.long))
    s, order = torch.sort(plin, stable=True)
    live = s < INT32_MAX
    is_first = torch.cat([live[:1], (s[1:] != s[:-1]) & live[1:]])
    rank = torch.cumsum(is_first.long(), 0) - 1
    tgt = torch.where(is_first & (rank < cap), rank,
                      torch.full_like(rank, cap))
    oc = torch.zeros((cap + 1, 3), dtype=torch.int32, device=dev)
    oc[tgt] = parent[order]
    omask = torch.zeros(cap + 1, dtype=torch.bool, device=dev)
    omask[tgt] = True
    oc, omask = oc[:cap], omask[:cap]

    offs = torch.as_tensor(_offsets(2), device=dev)
    row, ok = _gather_rows(grid, oc[:, None, :] * 2 + offs)
    out = _contract(_take_rows(grid.feats, row, ok), weight)
    if bias is not None:
        out = out + bias
    out = out * omask[:, None].to(out.dtype)
    return make_sparse_grid(oc, out, pdims, mask=omask), out


def sparse_conv_up(coarse: SparseGrid, fine_coords: torch.Tensor,
                   fine_mask: torch.Tensor, weight: torch.Tensor,
                   bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel-2 stride-2 transpose conv onto the saved fine coordinate set.
    weight (8,Ci,Co), the tap = the parity bits of the fine coord. Every
    fine row's parent goes through all 8 taps, (Mf,Ci) @ (Ci,8*Co), and
    the row keeps its own: no (Mf,Ci,Co) gather of weights."""
    tap = ((fine_coords[:, 0] & 1) * 4 + (fine_coords[:, 1] & 1) * 2
           + (fine_coords[:, 2] & 1)).long()
    row, ok = _gather_rows(coarse, fine_coords >> 1)
    f = _take_rows(coarse.feats, row, ok).to(weight.dtype)       # (Mf,Ci)
    K8, Ci, Co = weight.shape
    allt = (f @ weight.permute(1, 0, 2).reshape(Ci, K8 * Co)).reshape(
        -1, K8, Co)
    out = torch.gather(allt, 1, tap[:, None, None].expand(-1, 1, Co))[:, 0]
    if bias is not None:
        out = out + bias
    return out * fine_mask[:, None].to(out.dtype)


def sparse_batch_norm(feats, mask, p, eps=1e-5, act=None):
    """BatchNorm over live rows: the stored running statistics (BPNet
    freezes BN, `fix_bn`), else statistics of the live rows."""
    if "running_mean" in p and p.get("use_running", True) is not False:
        mean, var = p["running_mean"], p["running_var"]
    else:
        m = mask[:, None].to(feats.dtype)
        cnt = torch.clamp(m.sum(), min=1.0)
        mean = (feats * m).sum(0) / cnt
        var = ((feats - mean) ** 2 * m).sum(0) / cnt
    y = (feats - mean) * torch.rsqrt(var + eps) * p["weight"] + p["bias"]
    y = y * mask[:, None].to(y.dtype)
    return act(y) if act is not None else y
