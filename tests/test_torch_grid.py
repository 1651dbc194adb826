"""Port grid build (sgnerf_tpu_torch/ops/grid.py) vs the JAX reference:
the spec is equal and every table is bit-equal, for both cache dtypes and
with a short max_o/P cap that truncates buckets."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from sgnerf_tpu.models import point_cloud as jpc
from sgnerf_tpu_torch.models import point_cloud as tpc
from torch_threads import one_cpu_thread  # noqa: F401

FIELDS = ("occ_mask", "vox_slot", "bucket_pnts", "bucket_cnt", "bucket_xyz",
          "dil_slot", "nbr_packed", "coarse_occ")


def _cloud_xyz():
    rng = np.random.default_rng(0)
    xyz = rng.normal(size=(3000, 3)).astype(np.float32)
    xyz /= np.linalg.norm(xyz, axis=-1, keepdims=True)
    # duplicated points give exact distance ties in the cache sort
    return np.concatenate([xyz, xyz[:50]])


@pytest.mark.parametrize("cache_dtype,max_o,P,coarse", [
    ("bfloat16", None, None, 4),
    ("float32", None, None, 0),
    ("bfloat16", 300, 3, 4),          # caps short: truncation is bit-equal
])
def test_grid_tables_bit_equal(cache_dtype, max_o, P, coarse):
    xyz = _cloud_xyz()
    emb = np.zeros((len(xyz), 8), np.float32)
    jc = jpc.make_point_cloud(xyz, emb, capacity=len(xyz) + 100)
    tc = tpc.make_point_cloud(xyz, emb, capacity=len(xyz) + 100)
    kw = dict(vsize=[0.05] * 3, vscale=[2, 2, 2], kernel_size=[3, 3, 3],
              max_o=max_o, P=P, cache_dtype=cache_dtype,
              coarse_factor=coarse)
    jspec = jpc.grid_spec_for_cloud(jc, **kw)
    tspec = tpc.grid_spec_for_cloud(tc, **kw)
    assert dataclasses.asdict(jspec) == dataclasses.asdict(tspec)
    jg = jpc.build_grid(jc, jspec)
    tg = tpc.build_grid(tc, tspec)
    for f in FIELDS:
        a = np.asarray(getattr(jg, f))
        b = getattr(tg, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    if max_o is not None:
        assert int(jg.bucket_cnt.sum()) < len(xyz)   # the cap did truncate


def test_pack_unpack_roundtrip():
    from sgnerf_tpu_torch.ops.grid import GridSpec, pack_cache, unpack_cache
    rng = np.random.default_rng(1)
    xyz = torch.from_numpy(rng.normal(size=(5, 16, 3)).astype(np.float32))
    pid = torch.from_numpy(rng.integers(-1, 2 ** 31 - 1, size=(5, 16))
                           .astype(np.int32))
    for cd in ("bfloat16", "float32"):
        spec = GridSpec((0.0,) * 3, (1.0,) * 3, (1, 1, 1), 1, 1, (3, 3, 3),
                        nbr_cache=16, cache_dtype=cd)
        off, ids = unpack_cache(pack_cache(xyz, pid, cd), spec)
        torch.testing.assert_close(off.float(), xyz.to(off.dtype).float(),
                                   rtol=0, atol=0)
        assert torch.equal(ids, pid)
    # the JAX unpack reads the port's packed rows the same way
    from sgnerf_tpu.ops.grid import unpack_cache as junpack
    jspec = dataclasses.replace(jpc.GridSpec(
        (0.0,) * 3, (1.0,) * 3, (1, 1, 1), 1, 1, (3, 3, 3)),
        cache_dtype="bfloat16")
    _, jids = junpack(jax.numpy.asarray(
        pack_cache(xyz, pid, "bfloat16").numpy()), jspec)
    np.testing.assert_array_equal(np.asarray(jids), pid.numpy())
