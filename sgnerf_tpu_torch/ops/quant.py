"""Stochastic rounding and int8 quantization of the attribute table.

Counterpart of `sgnerf_tpu/ops/quant.py`. Training through a bf16
attribute table (`--gather_dtype bfloat16`) with round-to-nearest fits a
biased quantization of the point attributes; `--gather_round stochastic`
rounds up with probability equal to the fractional distance, so the bf16
table is an unbiased estimator of the float32 master. `--gather_dtype int8`
gathers a per-channel affine int8 copy of the table in the training
forward (`models/renderer.py` `gather_rows_int8`).

The random bits are drawn by the caller (`renderer.draw_render_noise`'s
`sr_bits`, 16 per element, as the JAX package draws them with
`jax.random.bits(key, shape, uint16)`), so tests can pass JAX's bits in.
"""
from __future__ import annotations

import numpy as np
import torch

_HI16 = -65536                      # 0xFFFF0000 as an int32


def sr_bits_values(x: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """float32 -> float32 values on the bf16 grid, stochastically rounded
    by 16 random low bits `bits` (x's shape, int16 or uint16 values in any
    integer dtype): (b + r) & 0xFFFF0000 on x's bit pattern b. JAX adds in
    uint32; here the sum is int32, which wraps only for NaN patterns, so
    every finite input gives JAX's bits."""
    r = bits.to(torch.int32) & 0xFFFF
    b = x.contiguous().view(torch.int32)
    return ((b + r) & _HI16).view(torch.float32)


def stochastic_round_bf16(x: torch.Tensor, bits: torch.Tensor
                          ) -> torch.Tensor:
    """Cast float32 -> bf16 with stochastic rounding (E[result] == x).
    Differentiable as `.to(torch.bfloat16)` is (identity through the
    cast); the draw carries no gradient. Finite inputs only."""
    assert x.dtype == torch.float32, x.dtype
    xs = x.detach()
    # x + (sr - x) is sr exactly (both lie within one bf16 ulp of x), so
    # the final cast rounds nothing
    return (x + (sr_bits_values(xs, bits) - xs)).to(torch.bfloat16)


@torch.no_grad()
def quantize_table_int8(x: torch.Tensor, mask: torch.Tensor):
    """Per-channel affine int8 quantization of an (N, C) float32 table.
    The channel ranges come from the rows where `mask` (N,) holds (the
    capacity padding would spoil them). Returns (q (N,C) int8, scale (C,),
    zero (C,)) with dequant(q) = q * scale + zero; no gradient. The range
    is divided by 254 as the JAX package's compiled step does it: XLA
    folds the division into a product with the float32 reciprocal."""
    xs = x.detach()
    m = mask[:, None]
    big = torch.finfo(torch.float32).max
    lo = torch.where(m, xs, big).amin(dim=0)
    hi = torch.where(m, xs, -big).amax(dim=0)
    ok = hi >= lo                       # an all-masked channel degenerates
    lo = torch.where(ok, lo, 0.0)
    hi = torch.where(ok, hi, 0.0)
    scale = torch.clamp_min(hi - lo, 1e-12) * float(np.float32(1 / 254))
    zero = (hi + lo) * 0.5
    q = torch.round((xs - zero) / scale).clamp(-127, 127).to(torch.int8)
    return q, scale, zero


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor,
                    zero: torch.Tensor) -> torch.Tensor:
    """q * scale + zero in float32 as XLA's CPU backend computes it, one
    fused multiply-add: the product of an int8 and a float32 is exact in
    float64, where the sum rounds, then once more to float32."""
    return torch.addcmul(zero.double(), q.double(), scale.double()).float()
