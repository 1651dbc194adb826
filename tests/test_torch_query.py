"""Port query (sgnerf_tpu_torch/ops/query.py) vs the JAX query_neighbors,
given the same raypos/tvals: sample_pidx, sample_loc_mask and ray_mask are
bit-equal on the exact and fused (K1 plain version) cache paths, with and
without the two-level compaction, and on the bucket path (nbr_cache 0).
Shading-point positions agree to float32 rounding: XLA contracts
campos + t*dir into fused multiply-adds in some lanes and not others."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgnerf_tpu.models import point_cloud as jpc
from sgnerf_tpu.ops.query import query_neighbors as jquery
from sgnerf_tpu.ops.raygen import near_far_linear_ray_generation as jraygen
from sgnerf_tpu_torch.models import point_cloud as tpc
from sgnerf_tpu_torch.ops.query import query_neighbors as tquery


def _scene(cache_dtype, coarse, nbr_cache=64):
    rng = np.random.default_rng(3)
    n = 6000
    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    xyz /= np.linalg.norm(xyz, axis=-1, keepdims=True)
    xyz *= rng.uniform(0.9, 1.1, size=(n, 1)).astype(np.float32)
    emb = np.zeros((n, 4), np.float32)
    kw = dict(vsize=[0.04] * 3, vscale=[2, 2, 2], kernel_size=[3, 3, 3],
              max_o=None, P=None, cache_dtype=cache_dtype,
              coarse_factor=coarse, seg_len=4, seg_cap=24,
              nbr_cache=nbr_cache)
    jc = jpc.make_point_cloud(xyz, emb)
    tc = tpc.make_point_cloud(xyz, emb)
    jg = jpc.build_grid(jc, jpc.grid_spec_for_cloud(jc, **kw))
    tg = tpc.build_grid(tc, tpc.grid_spec_for_cloud(tc, **kw))
    return jc, jg, tg


def _rays(R=96, D=64):
    rng = np.random.default_rng(11)
    d = (rng.normal(size=(1, R, 3)) * 0.3).astype(np.float32)
    d[..., 2] = 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    campos = np.asarray([[0.0, 0.0, -3.0]], np.float32)
    raypos, _, _, ts = jraygen(jnp.asarray(campos), jnp.asarray(d), D,
                               near=1.0, far=5.0)
    return campos, d, np.array(raypos), np.array(ts)


@pytest.mark.parametrize("cache_dtype,coarse,knn,lazy,nbr_cache", [
    ("bfloat16", 4, "fused", True, 64),
    ("bfloat16", 4, "exact", True, 64),
    ("bfloat16", 0, "fused", False, 64),
    ("float32", 4, "exact", False, 64),
    ("float32", 0, "exact", False, 0),      # bucket_candidates path
])
def test_query_matches_reference(cache_dtype, coarse, knn, lazy, nbr_cache):
    jc, jg, tg = _scene(cache_dtype, coarse, nbr_cache)
    campos, d, raypos, ts = _rays()
    extra_j = dict(campos=jnp.asarray(campos), raydir=jnp.asarray(d),
                   tvals=jnp.asarray(ts)) if lazy else {}
    extra_t = dict(campos=torch.from_numpy(campos), raydir=torch.from_numpy(d),
                   tvals=torch.from_numpy(ts)) if lazy else {}
    q0 = jquery(jg, jc.xyz, jnp.asarray(raypos), K=4, SR=8,
                radius_limit=0.16, knn_mode=knn, **extra_j)
    q1 = tquery(tg, torch.from_numpy(raypos), K=4, SR=8, radius_limit=0.16,
                knn_mode=knn, **extra_t)
    np.testing.assert_array_equal(q1.sample_pidx.numpy(),
                                  np.asarray(q0.sample_pidx))
    np.testing.assert_array_equal(q1.sample_loc_mask.numpy(),
                                  np.asarray(q0.sample_loc_mask))
    np.testing.assert_array_equal(q1.ray_mask.numpy(),
                                  np.asarray(q0.ray_mask))
    np.testing.assert_allclose(q1.sample_loc_w.numpy(),
                               np.asarray(q0.sample_loc_w), rtol=0,
                               atol=1e-6)
    assert int((q1.sample_pidx >= 0).sum()) > 200


def test_compact_hits_ties_in_index_order():
    from sgnerf_tpu.ops.query import compact_hits as jcompact
    from sgnerf_tpu_torch.ops.query import compact_hits as tcompact
    hit = np.random.default_rng(0).random((4, 9, 40)) < 0.2
    a = jcompact(jnp.asarray(hit), 6)
    b = tcompact(torch.from_numpy(hit), 6)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
