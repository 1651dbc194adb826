"""The tile-dedup KNN path: `tile_unique` (sgnerf_tpu_torch/ops/fused_knn.py)
bit-equal to the JAX package's, kernel K6's plain version
(`fused_knn_select_tiled`, CPU tensors) bit-equal to the JAX
fused_knn_select_tiled (Pallas, interpret mode on the CPU), and
query_neighbors(knn_mode="dedup") ids bit-equal to the JAX query, with and
without tiles that overflow their cap. Tiles are kept small (4 rays of
SR 8) so interpret mode stays fast.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgnerf_tpu.ops.fused_knn import fused_knn_select_tiled as jax_tiled
from sgnerf_tpu.ops.fused_knn import tile_unique as jax_tile_unique
from sgnerf_tpu_torch.ops.fused_knn import (fused_knn_select,
                                            fused_knn_select_tiled,
                                            tile_unique)
from torch_threads import one_cpu_thread  # noqa: F401


@pytest.mark.parametrize("M,T,U,n_slots,overflow", [
    (1024, 128, 64, 40, False),  # every distinct slot fits, -1 padding
    (1024, 128, 16, 40, True),   # tiles overflow U: inv == U past the cap
    (96, 32, 32, 500, False),    # mostly distinct slots, some negative
])
def test_tile_unique_bit_equal_to_jax(M, T, U, n_slots, overflow):
    rng = np.random.default_rng(M + U)
    slot = rng.integers(-3, n_slots, size=(M,)).astype(np.int32)
    ok = (rng.random(M) < 0.8) & (slot >= 0)
    ref_u, ref_i = jax_tile_unique(jnp.asarray(slot), jnp.asarray(ok), T, U)
    uniq, inv = tile_unique(torch.from_numpy(slot), torch.from_numpy(ok),
                            T, U)
    assert uniq.dtype == inv.dtype == torch.int32
    np.testing.assert_array_equal(uniq.numpy(), np.asarray(ref_u))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(ref_i))
    assert bool((uniq == -1).any()) != overflow
    assert bool(((inv == U) & torch.from_numpy(ok)).any()) == overflow


def _tiled_inputs(seed, nt=3, T=64, U=24, C=64):
    """Planar bf16 cache rows with exact ties and padding ids, U per tile,
    and the inv of tile_unique over random slots (some rows overflow)."""
    rng = np.random.default_rng(seed)
    n = nt * U
    off = rng.normal(scale=0.02, size=(n, C, 3)).astype(np.float32)
    off[:, 1::7] = off[:, 0:1]                  # duplicated offsets: d2 ties
    pid = rng.integers(0, 1 << 24, size=(n, C)).astype(np.int32)
    pid[:, 2::5] = -1                           # padding candidates
    off[pid < 0] = 1e9                          # padding parks far away
    xi = torch.from_numpy(off).to(torch.bfloat16).view(torch.int16)
    pi = torch.from_numpy(pid).view(torch.int16).reshape(n, C, 2)
    rows = torch.cat([xi.movedim(-1, -2).reshape(n, -1),
                      pi.movedim(-1, -2).reshape(n, -1)], dim=-1)
    slot = torch.from_numpy(rng.integers(0, 30, size=nt * T).astype(np.int32))
    ok = torch.from_numpy(rng.random(nt * T) < 0.85)
    _, inv = tile_unique(slot, ok, T, U)
    delta = torch.from_numpy(
        rng.normal(scale=0.02, size=(nt * T, 3)).astype(np.float32))
    return rows, inv, delta, ok


@pytest.mark.parametrize("radius,K", [(0.03, 8), (0.0, 4)])
def test_plain_k6_bit_equal_to_jax(radius, K):
    T, U, C = 64, 24, 64
    rows, inv, delta, ok = _tiled_inputs(int(radius * 100) + K, T=T, U=U)
    r2 = float(np.float32(radius) * np.float32(radius))
    got = fused_knn_select_tiled(rows, inv, delta, ok, r2, C=C, K=K, T=T, U=U)
    ref = jax_tiled(jnp.asarray(rows.numpy()), jnp.asarray(inv.numpy()),
                    jnp.asarray(delta.numpy()), jnp.asarray(ok.numpy()), r2,
                    C=C, K=K, T=T, U=U)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got.dtype == torch.int32 and got.shape == (inv.shape[0], K)
    dropped = (inv == U) | ~ok
    assert dropped.any() and (got[dropped] == -1).all()
    # every other point gets K1's ids on its own row
    tile = torch.arange(inv.shape[0]) // T
    own = rows[tile * U + inv.clamp(max=U - 1).long()]
    k1 = fused_knn_select(own, delta, ok, r2, C=C, K=K)
    assert torch.equal(got[~dropped], k1[~dropped])
    assert (got >= 0).sum() > 0


def test_k6_wrapper_rejects_bad_inputs():
    rows, inv, delta, ok = _tiled_inputs(0)
    with pytest.raises(ValueError, match="rows per tile"):
        fused_knn_select_tiled(rows[:-1], inv, delta, ok, 0.0, C=64, K=8,
                               T=64, U=24)
    with pytest.raises(ValueError, match="inv"):
        fused_knn_select_tiled(rows, inv.long(), delta, ok, 0.0, C=64, K=8,
                               T=64, U=24)


@pytest.mark.parametrize("cap", [32, 6])
def test_query_dedup_bit_equal_to_jax(cap):
    """dedup_tile 4 rays x SR 8 = 32 points a tile: cap 32 cannot overflow
    (the ids then equal the fused path's too); cap 6 overflows."""
    from test_torch_query import _rays, _scene
    from sgnerf_tpu.ops.query import query_neighbors as jquery
    from sgnerf_tpu_torch.ops.query import query_neighbors as tquery

    jc, jg, tg = _scene("bfloat16", 4)
    campos, d, raypos, ts = _rays(R=90)     # 720 points: a padded last tile
    kw = dict(K=4, SR=8, radius_limit=0.16, dedup_tile=4, dedup_cap=cap)
    q0 = jquery(jg, jc.xyz, jnp.asarray(raypos), knn_mode="dedup",
                campos=jnp.asarray(campos), raydir=jnp.asarray(d),
                tvals=jnp.asarray(ts), **kw)
    tin = dict(campos=torch.from_numpy(campos), raydir=torch.from_numpy(d),
               tvals=torch.from_numpy(ts))
    q1 = tquery(tg, torch.from_numpy(raypos), knn_mode="dedup", **tin, **kw)
    np.testing.assert_array_equal(q1.sample_pidx.numpy(),
                                  np.asarray(q0.sample_pidx))
    np.testing.assert_array_equal(q1.ray_mask.numpy(),
                                  np.asarray(q0.ray_mask))
    fused = tquery(tg, torch.from_numpy(raypos), knn_mode="fused", **tin,
                   **kw).sample_pidx
    found = q1.sample_pidx >= 0
    assert int(found.sum()) > 200
    if cap == 32:
        assert torch.equal(q1.sample_pidx, fused)
    else:
        lost = (fused >= 0).any(-1) & ~found.any(-1)
        assert lost.any()
        assert torch.equal(q1.sample_pidx[~lost], fused[~lost])
