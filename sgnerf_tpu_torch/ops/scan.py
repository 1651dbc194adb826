"""Inclusive scans along the last axis in a fixed summation order.

`torch.cumsum`/`cumprod` accumulate float32 in double on the CPU and in a
parallel order on the card, so neither reproduces the reference. XLA lowers
a long scan to blocks of 16: a sequential scan inside each block, then the
block totals are scanned the same way and each block's exclusive prefix is
combined with its elements. Sample depths (cumsum over D) and
transmittance (cumprod over SR) follow that order here, so they agree with
the JAX reference bit for bit (sums at every length; products up to 257
terms) and are the same function on every device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

_BLOCK = 16


def ordered_scan(x: torch.Tensor, op) -> torch.Tensor:
    """Inclusive scan of `x` over its last axis with `op` (torch.add or
    torch.mul)."""
    n = x.shape[-1]
    if n <= _BLOCK:
        outs = [x[..., 0]]
        for i in range(1, n):
            outs.append(op(outs[-1], x[..., i]))
        return torch.stack(outs, dim=-1)
    ident = 0.0 if op is torch.add else 1.0
    nb = -(-n // _BLOCK)
    xp = F.pad(x, (0, nb * _BLOCK - n), value=ident)
    inner = ordered_scan(xp.reshape(*x.shape[:-1], nb, _BLOCK), op)
    outer = ordered_scan(inner[..., -1], op)
    excl = F.pad(outer[..., :-1], (1, 0), value=ident)
    out = op(excl[..., None], inner)
    return out.reshape(*x.shape[:-1], nb * _BLOCK)[..., :n]
