"""K7: row gather out[s] = table[idx[s]], its staged form, and the sorted
segment-sum transpose.

Counterpart of `sgnerf_tpu/ops/pallas_gather.py` `gather_rows_pallas` (a
per-row async-DMA gather on the TPU). Both kernels are in
`csrc/gather_rows.cu` (its header says what bounds them and how they copy):
`gather_rows_pallas` copies rows through registers, `wave` rows in flight a
warp; `gather_rows_staged` stages each row in shared memory by a TMA bulk
copy, the counterpart of the TPU probes' VMEM-staged DMA ring
(`sgnerf_tpu_torch/dev/probe_gather.py` times the two). The plain version
is `index_select`, which is also the one PyTorch call for the function.
The wrappers run it only for tensors on the CPU; for CUDA tensors they
launch the kernels or raise.

The transpose of `gather_rows_pallas` is the JAX `_bwd`: the cotangent rows
sorted by id (a stable sort), each run of equal ids summed in order, in
the cotangent's dtype (`sorted_segment_sum`; the same bits on every run,
where `index_add_`'s atomics vary in the last bits on CUDA).
"""
from __future__ import annotations

import torch

from . import _cuda


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K7: table (T, ROW), idx (...) -> (..., ROW)."""
    return table.index_select(0, idx.reshape(-1)).reshape(
        *idx.shape, table.shape[1])


def sorted_segment_sum(flat_idx: torch.Tensor, rows: torch.Tensor,
                       n_rows: int) -> torch.Tensor:
    """rows (S, ROW) summed by id flat_idx (S,) into (n_rows, ROW), in
    rows' dtype: a stable sort by id, then one sequential sum per run of
    equal ids (`torch.segment_reduce`), written to the runs' rows
    (`index_copy_`; the ids are distinct). Deterministic on CUDA."""
    out = rows.new_zeros((n_rows,) + rows.shape[1:])
    if flat_idx.numel() == 0:
        return out
    ids, order = torch.sort(flat_idx.long(), stable=True)
    uniq, counts = torch.unique_consecutive(ids, return_counts=True)
    sums = torch.segment_reduce(rows.index_select(0, order), "sum",
                                lengths=counts)
    return out.index_copy_(0, uniq, sums)


def _check(table: torch.Tensor, idx: torch.Tensor, name: str):
    if table.dim() != 2 or table.shape[0] < 1:
        raise ValueError(f"{name}: table must be (T >= 1, ROW), got "
                         f"{tuple(table.shape)}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"{name}: idx must be int32 or int64, got "
                         f"{idx.dtype}")
    if idx.device != table.device:
        raise ValueError(f"{name}: table and idx must share one device")
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: tensors on {table.device} are not "
                         "supported")


def _launch(entry: str, table: torch.Tensor, idx: torch.Tensor,
            wave: int) -> torch.Tensor:
    """One launch of csrc/gather_rows.cu `entry` on CUDA tensors."""
    table = table.contiguous()
    flat = idx.reshape(-1).to(torch.int32).contiguous()
    S, row_bytes = flat.shape[0], table.shape[1] * table.element_size()
    out = torch.empty((S, table.shape[1]), dtype=table.dtype,
                      device=table.device)
    lib = _cuda.load("gather_rows")
    with torch.cuda.device(table.device):
        err = getattr(lib, entry)(
            _cuda.ptr(table), _cuda.ptr(flat), _cuda.ptr(out), S, row_bytes,
            table.shape[0], int(wave), _cuda.stream_of(table))
    _cuda.check(lib, err, entry)
    return out.reshape(*idx.shape, table.shape[1])


class _GatherRowsPallas(torch.autograd.Function):
    """K7 forward; the JAX `_bwd` transpose (sorted segment sum in the
    cotangent's dtype)."""

    @staticmethod
    def forward(ctx, table, idx, wave):
        ctx.save_for_backward(idx)
        ctx.n_rows = table.shape[0]
        if table.device.type == "cpu":
            return gather_rows_plain(table, idx)
        out = _launch("gather_rows", table, idx, wave)
        gather_rows_pallas.launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        return (sorted_segment_sum(idx.reshape(-1),
                                   g.reshape(-1, g.shape[-1]), ctx.n_rows),
                None, None)


def gather_rows_pallas(table: torch.Tensor, idx: torch.Tensor,
                       wave: int = 16) -> torch.Tensor:
    """table (T, ROW) of any dtype, idx (...) int32/int64 in [0, T) ->
    (..., ROW), differentiable in `table`. `wave` is the number of rows a
    warp keeps in flight (the TPU kernel's DMA semaphores). Ids outside
    [0, T) are clamped on the card; pass clipped ids, as the JAX entry
    requires. `gather_rows_pallas.launches` counts kernel launches."""
    _check(table, idx, "gather_rows_pallas")
    if wave < 1:
        raise ValueError(f"gather_rows_pallas: wave must be >= 1, got {wave}")
    return _GatherRowsPallas.apply(table, idx, wave)


gather_rows_pallas.launches = 0


def gather_rows_staged(table: torch.Tensor, idx: torch.Tensor,
                       wave: int = 16) -> torch.Tensor:
    """The same function as gather_rows_pallas (no gradient), each row
    staged in shared memory by a TMA bulk copy, `wave` rows in flight a
    warp. On the card the rows must be multiples of 16 bytes at 16-byte
    aligned addresses. `gather_rows_staged.launches` counts kernel
    launches."""
    _check(table, idx, "gather_rows_staged")
    if table.device.type == "cpu":
        return gather_rows_plain(table, idx)
    table = table.contiguous()
    if (table.shape[1] * table.element_size()) % 16 or table.data_ptr() % 16:
        raise ValueError("gather_rows_staged: rows must be multiples of 16 "
                         "bytes at 16-byte aligned addresses (TMA bulk "
                         f"copies); got {table.shape[1]} x "
                         f"{table.element_size()} bytes")
    out = _launch("gather_rows_staged", table, idx, wave)
    gather_rows_staged.launches += 1
    return out


gather_rows_staged.launches = 0
