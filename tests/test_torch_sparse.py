"""The port's sparse 3D convolutions (sgnerf_tpu_torch/ops/sparse.py)
against the JAX package's (sgnerf_tpu/ops/sparse.py) on the same seeded
grids: coords, rows, masks and lookups bit-equal; features within 1e-5
(f32, the same products summed in another order). Then the dense-conv
oracle of tests/test_bpnet.py applied to the port."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgnerf_tpu.ops import sparse as jsp
from sgnerf_tpu_torch.ops import sparse as tsp
from torch_threads import one_cpu_thread  # noqa: F401

ATOL = 1e-5


def _grid_np(n=90, dims=(16, 14, 12), c=4, pad=0, seed=0):
    """Unique coords, features, and `pad` padding rows (mask False) at
    random coords, interleaved."""
    rng = np.random.default_rng(seed)
    coords = np.unique(np.stack([rng.integers(0, d, n) for d in dims], -1),
                       axis=0).astype(np.int32)
    feats = rng.normal(size=(len(coords), c)).astype(np.float32)
    mask = np.ones(len(coords), bool)
    if pad:
        pc = np.stack([rng.integers(0, d, pad) for d in dims], -1)
        coords = np.concatenate([coords, pc.astype(np.int32)])
        feats = np.concatenate([feats, rng.normal(size=(pad, c)).astype(
            np.float32)])
        mask = np.concatenate([mask, np.zeros(pad, bool)])
        perm = rng.permutation(len(coords))
        coords, feats, mask = coords[perm], feats[perm], mask[perm]
    return coords, feats, mask, dims


def _both(coords, feats, mask, dims):
    j = jsp.make_sparse_grid(jnp.asarray(coords), jnp.asarray(feats), dims,
                             mask=jnp.asarray(mask))
    t = tsp.make_sparse_grid(torch.as_tensor(coords), torch.as_tensor(feats),
                             dims, mask=torch.as_tensor(mask))
    return j, t


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("pad", [0, 7])
def test_make_sparse_grid_and_gather_rows_bit_equal(pad):
    coords, feats, mask, dims = _grid_np(pad=pad, seed=pad)
    j, t = _both(coords, feats, mask, dims)
    _eq(j.lookup, t.lookup)
    _eq(j.coords, t.coords)
    _eq(j.mask, t.mask)
    rng = np.random.default_rng(3)
    q = rng.integers(-2, 18, size=(60, 5, 3)).astype(np.int32)
    jr, jok = jsp._gather_rows(j, jnp.asarray(q))
    tr, tok = tsp._gather_rows(t, torch.as_tensor(q))
    _eq(jr, tr)
    _eq(jok, tok)


@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("bias", [False, True])
def test_sparse_conv_matches_jax(k, bias):
    coords, feats, mask, dims = _grid_np(pad=5, seed=k)
    j, t = _both(coords, feats, mask, dims)
    rng = np.random.default_rng(10 + k)
    w = rng.normal(size=(k ** 3, 4, 6)).astype(np.float32)
    b = rng.normal(size=(6,)).astype(np.float32) if bias else None
    got = tsp.sparse_conv(t, torch.as_tensor(w),
                          None if b is None else torch.as_tensor(b),
                          kernel_size=k)
    want = jsp.sparse_conv(j, jnp.asarray(w),
                           None if b is None else jnp.asarray(b),
                           kernel_size=k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("cap", [200, 30])
def test_sparse_conv_down_matches_jax(cap):
    """Coarse coords, mask and lookup bit-equal, also when the capacity
    drops parents (cap 30 < the unique parents)."""
    coords, feats, mask, dims = _grid_np(n=150, pad=9, seed=4)
    j, t = _both(coords, feats, mask, dims)
    w = np.random.default_rng(5).normal(size=(8, 4, 5)).astype(np.float32)
    jg, jf = jsp.sparse_conv_down(j, jnp.asarray(w), cap)
    tg, tf = tsp.sparse_conv_down(t, torch.as_tensor(w), cap)
    assert tg.dims == tuple(jg.dims)
    _eq(jg.coords, tg.coords)
    _eq(jg.mask, tg.mask)
    _eq(jg.lookup, tg.lookup)
    if cap == 30:
        assert int(np.asarray(jg.mask).sum()) == 30
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=ATOL)
    np.testing.assert_allclose(tg.feats.numpy(), np.asarray(jg.feats),
                               atol=ATOL)


def test_sparse_conv_up_matches_jax():
    coords, feats, mask, dims = _grid_np(n=150, pad=6, seed=6)
    j, t = _both(coords, feats, mask, dims)
    rng = np.random.default_rng(7)
    wd = rng.normal(size=(8, 4, 5)).astype(np.float32)
    wu = rng.normal(size=(8, 5, 3)).astype(np.float32)
    b = rng.normal(size=(3,)).astype(np.float32)
    jg, _ = jsp.sparse_conv_down(j, jnp.asarray(wd), 128)
    tg, _ = tsp.sparse_conv_down(t, torch.as_tensor(wd), 128)
    want = jsp.sparse_conv_up(jg, j.coords, j.mask, jnp.asarray(wu),
                              jnp.asarray(b))
    got = tsp.sparse_conv_up(tg, t.coords, t.mask, torch.as_tensor(wu),
                             torch.as_tensor(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("running", [True, False])
def test_sparse_batch_norm_matches_jax(running):
    rng = np.random.default_rng(8)
    x = rng.normal(size=(40, 6)).astype(np.float32) * 3 + 1
    mask = rng.uniform(size=40) > 0.2
    p = {"weight": rng.normal(size=6), "bias": rng.normal(size=6)}
    if running:
        p.update(running_mean=rng.normal(size=6),
                 running_var=rng.uniform(0.5, 2.0, 6))
    p = {k: v.astype(np.float32) for k, v in p.items()}
    want = jsp.sparse_batch_norm(jnp.asarray(x), jnp.asarray(mask),
                                 {k: jnp.asarray(v) for k, v in p.items()},
                                 act=lambda y: jnp.maximum(y, 0))
    got = tsp.sparse_batch_norm(torch.as_tensor(x), torch.as_tensor(mask),
                                {k: torch.as_tensor(v) for k, v in p.items()},
                                act=torch.relu)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_offsets_equal_jax():
    for k in (1, 2, 3, 5):
        np.testing.assert_array_equal(tsp._offsets(k), jsp._offsets(k))


@pytest.mark.parametrize("k", [3, 5])
def test_sparse_conv_matches_dense_oracle(k):
    """tests/test_bpnet.py's dense oracle, on the port: each output row is
    the sum over in-box offsets of the neighbour's row times its tap."""
    coords, feats, mask, dims = _grid_np(n=50, dims=(16, 16, 16), seed=11)
    t = tsp.make_sparse_grid(torch.as_tensor(coords), torch.as_tensor(feats),
                             dims)
    w = np.random.default_rng(12).normal(size=(k ** 3, 4, 6)).astype(
        np.float32)
    out = tsp.sparse_conv(t, torch.as_tensor(w), kernel_size=k).numpy()
    dense = np.zeros((16, 16, 16, 4), np.float32)
    dense[coords[:, 0], coords[:, 1], coords[:, 2]] = feats
    r = np.arange(k) - k // 2
    offs = np.stack(np.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
    for i, c in enumerate(coords):
        acc = np.zeros(6, np.float32)
        for ki, o in enumerate(offs):
            q = c + o
            if ((q >= 0) & (q < 16)).all():
                acc += dense[q[0], q[1], q[2]] @ w[ki]
        np.testing.assert_allclose(out[i], acc, atol=1e-4)


def test_down_then_up_keeps_the_fine_coords():
    """The coarse set is the unique parents; the transpose conv lands on
    the saved fine rows only (padding rows zero)."""
    coords, feats, mask, dims = _grid_np(n=80, pad=4, seed=2)
    t = tsp.make_sparse_grid(torch.as_tensor(coords), torch.as_tensor(feats),
                             dims, mask=torch.as_tensor(mask))
    w = torch.as_tensor(np.random.default_rng(3).normal(
        size=(8, 4, 5)).astype(np.float32))
    down, _ = tsp.sparse_conv_down(t, w, out_capacity=128)
    dc = down.coords[down.mask].numpy()
    want = np.unique(coords[mask] // 2, axis=0)
    np.testing.assert_array_equal(dc, want)     # ascending linear order
    up = tsp.sparse_conv_up(dataclasses.replace(down), t.coords, t.mask,
                            torch.as_tensor(np.ones((8, 5, 3), np.float32)))
    assert up.shape == (t.M, 3)
    assert (up[~t.mask] == 0).all()
