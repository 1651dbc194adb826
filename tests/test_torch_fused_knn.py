"""Kernel K1's plain version (sgnerf_tpu_torch/ops/fused_knn.py) vs the
JAX fused_knn_select (Pallas, interpret mode on the CPU): ids bit-equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgnerf_tpu.ops.fused_knn import fused_knn_select as jax_select
from sgnerf_tpu_torch.ops.fused_knn import fused_knn_select
from torch_threads import one_cpu_thread  # noqa: F401


def _rows(seed, M=300, C=64):
    """Planar bf16 cache rows with exact ties, padding ids and rows with
    fewer than K valid candidates."""
    rng = np.random.default_rng(seed)
    off = rng.normal(scale=0.02, size=(M, C, 3)).astype(np.float32)
    off[:, 1::7] = off[:, 0:1]                  # duplicated offsets: d2 ties
    pid = rng.integers(0, 1 << 24, size=(M, C)).astype(np.int32)
    pid[:, 2::5] = -1                           # padding candidates
    pid[:20, 3:] = -1                           # rows with 3 valid at most
    off[pid < 0] = 1e9                          # padding parks far away
    xi = torch.from_numpy(off).to(torch.bfloat16).view(torch.int16)
    pi = torch.from_numpy(pid).view(torch.int16).reshape(M, C, 2)
    rows = torch.cat([xi.movedim(-1, -2).reshape(M, -1),
                      pi.movedim(-1, -2).reshape(M, -1)], dim=-1)
    delta = rng.normal(scale=0.02, size=(M, 3)).astype(np.float32)
    ok = rng.random(M) < 0.85
    return rows, torch.from_numpy(delta), torch.from_numpy(ok)


@pytest.mark.parametrize("radius,K,C", [(0.03, 8, 64), (0.0, 8, 64),
                                        (0.05, 4, 32)])
def test_plain_k1_bit_equal_to_jax(radius, K, C):
    rows, delta, ok = _rows(int(radius * 100) + K, C=C)
    r2 = float(np.float32(radius) * np.float32(radius))
    got = fused_knn_select(rows, delta, ok, r2, C=C, K=K)
    ref = jax_select(jnp.asarray(rows.numpy()), jnp.asarray(delta.numpy()),
                     jnp.asarray(ok.numpy()), r2, C=C, K=K)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got.dtype == torch.int32 and got.shape == (rows.shape[0], K)
    assert (got[~ok] == -1).all()
    assert (got >= 0).sum() > 0 and (got[ok] == -1).sum() > 0


def test_k1_wrapper_rejects_bad_inputs():
    rows, delta, ok = _rows(0)
    with pytest.raises(ValueError):
        fused_knn_select(rows.to(torch.int32), delta, ok, 0.0, C=64, K=8)
    with pytest.raises(ValueError):
        fused_knn_select(rows, delta[:5], ok, 0.0, C=64, K=8)
    with pytest.raises(ValueError):
        fused_knn_select(rows, delta, ok, 0.0, C=64, K=65)
