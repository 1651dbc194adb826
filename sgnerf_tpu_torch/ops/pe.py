"""Positional encoding in the reference's layout (counterpart of
`sgnerf_tpu/ops/pe.py`; reference helpers/networks.py:175-192):

  * the frequency axis is innermost per input channel:
    [x0*f0, x0*f1, ..., x1*f0, ...]
  * sin/cos interleave per element: [sin(a0), cos(a0), sin(a1), ...]
  * with ori=True the layout is [x | sin(all) | cos(all)] instead.
"""
from __future__ import annotations

import torch


def positional_encoding(positions: torch.Tensor, freqs: int,
                        ori: bool = False) -> torch.Tensor:
    """(..., D) -> (..., 2*D*freqs), or (..., D + 2*D*freqs) with ori."""
    bands = 2.0 ** torch.arange(freqs, dtype=positions.dtype,
                                device=positions.device)
    pts = (positions[..., None] * bands).reshape(
        positions.shape[:-1] + (freqs * positions.shape[-1],))
    if ori:
        return torch.cat([positions, torch.sin(pts), torch.cos(pts)], dim=-1)
    out = torch.stack([torch.sin(pts), torch.cos(pts)], dim=-1)
    return out.reshape(positions.shape[:-1] + (2 * pts.shape[-1],))
