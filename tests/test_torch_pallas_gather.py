"""K7 (`gather_rows_pallas`) and `--gather_vjp sorted` (`gather_rows`) in
the port against the JAX package on the CPU.

  * K7's plain path (index_select) against JAX `gather_rows_pallas` in
    interpret mode, on the cases of tests/test_pallas_gather.py: int16 and
    f32 tables, multi-dim ids, bit-equal; its transpose (a stable sort and
    a sequential segment sum in the cotangent's dtype) within 1e-6.
  * The renderer's `gather_rows` against JAX `gather_rows`: forward
    bit-equal, transpose within 1e-6 in f32, and on a bf16 table the sums
    taken in f32 before one rounding to bf16.
  * A render with `gather_vjp="sorted"` against the default scatter-add
    transpose: the same loss and cloud gradients (1e-6).
  * The probe module's bound and the staged form's CPU path.
  * A model of the staged kernel's ring of slots (waits, reloads) for
    waves 1-32: every row arrives before its wait, so the card cannot hang.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgnerf_tpu.models.renderer import gather_rows as jgather_rows
from sgnerf_tpu.ops.pallas_gather import gather_rows_pallas as jgather
from sgnerf_tpu_torch.models.renderer import gather_rows
from sgnerf_tpu_torch.ops.pallas_gather import (gather_rows_pallas,
                                                gather_rows_plain,
                                                gather_rows_staged,
                                                sorted_segment_sum)
from torch_threads import one_cpu_thread  # noqa: F401

DTYPES = {"int16": (np.int16, jnp.int16, torch.int16),
          "float32": (np.float32, jnp.float32, torch.float32)}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_gather_matches_jax(dtype):
    npt, jt, tt = DTYPES[dtype]
    rng = np.random.default_rng(0)
    T, ROW, S = 257, 40, 133
    table = rng.standard_normal((T, ROW)).astype(np.float32)
    idx = rng.integers(0, T, (S,), dtype=np.int32)
    ref = np.asarray(jgather(jnp.asarray(table).astype(jt), jnp.asarray(idx),
                             4, True))
    got = gather_rows_pallas(torch.from_numpy(table).to(tt),
                             torch.from_numpy(idx), wave=4)
    assert got.dtype == tt
    np.testing.assert_array_equal(got.numpy(), ref)
    staged = gather_rows_staged(torch.from_numpy(table).to(tt),
                                torch.from_numpy(idx), wave=4)
    np.testing.assert_array_equal(staged.numpy(), ref)


def test_gather_multidim_idx_matches_jax():
    rng = np.random.default_rng(1)
    T, ROW = 64, 8
    table = rng.standard_normal((T, ROW)).astype(np.float32)
    idx = rng.integers(0, T, (6, 5, 4), dtype=np.int32)
    ref = np.asarray(jgather(jnp.asarray(table), jnp.asarray(idx), 4, True))
    got = gather_rows_pallas(torch.from_numpy(table), torch.from_numpy(idx),
                             wave=4)
    assert tuple(got.shape) == ref.shape == (6, 5, 4, ROW)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        gather_rows_plain(torch.from_numpy(table),
                          torch.from_numpy(idx).long()).numpy(), ref)


@pytest.mark.parametrize("shape", [(96,), (12, 8)])
def test_gather_vjp_matches_jax(shape):
    rng = np.random.default_rng(2)
    T, ROW = 32, 8                      # duplicate ids guaranteed
    table = rng.standard_normal((T, ROW)).astype(np.float32)
    idx = rng.integers(0, T, shape, dtype=np.int32)
    g = rng.standard_normal(shape + (ROW,)).astype(np.float32)
    _, vjp = jax.vjp(lambda t: jgather(t, jnp.asarray(idx), 4, True),
                     jnp.asarray(table))
    ref = np.asarray(vjp(jnp.asarray(g))[0])
    t = torch.from_numpy(table).requires_grad_(True)
    out = gather_rows_pallas(t, torch.from_numpy(idx), wave=4)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(t.grad.numpy(), ref, rtol=1e-6, atol=1e-6)
    # the XLA gather's own transpose, as the JAX test holds it
    _, vjp_x = jax.vjp(lambda t_: t_[jnp.asarray(idx)], jnp.asarray(table))
    np.testing.assert_allclose(t.grad.numpy(),
                               np.asarray(vjp_x(jnp.asarray(g))[0]),
                               rtol=1e-6, atol=1e-6)


def test_sorted_segment_sum_is_in_order_and_in_dtype():
    """Each id's rows summed in their order in the input, in the rows'
    dtype; ids that never occur get zeros; no ids give zeros."""
    rng = np.random.default_rng(3)
    idx = torch.from_numpy(rng.integers(0, 7, 50)).to(torch.int32)
    rows = torch.from_numpy(rng.standard_normal((50, 3)).astype(np.float32))
    got = sorted_segment_sum(idx, rows, 9)
    ref = torch.zeros(9, 3)
    for i in range(50):
        ref[int(idx[i])] += rows[i]
    assert torch.equal(got, ref)
    assert torch.equal(sorted_segment_sum(idx, rows.to(torch.bfloat16), 9),
                       sorted_segment_sum(idx, rows.to(torch.bfloat16), 9))
    assert sorted_segment_sum(idx, rows.to(torch.bfloat16), 9).dtype == \
        torch.bfloat16
    assert torch.equal(sorted_segment_sum(idx[:0], rows[:0], 4),
                       torch.zeros(4, 3))


def test_sorted_gather_rows_matches_jax():
    """--gather_vjp sorted: forward bit-equal, transpose within 1e-6."""
    rng = np.random.default_rng(5)
    table = rng.normal(size=(40, 7)).astype(np.float32)
    idx = rng.integers(0, 40, size=(3, 8, 2)).astype(np.int32)
    cot = rng.normal(size=(3, 8, 2, 7)).astype(np.float32)
    jout, vjp = jax.vjp(lambda t: jgather_rows(t, jnp.asarray(idx)),
                        jnp.asarray(table))
    t = torch.from_numpy(table).requires_grad_(True)
    out = gather_rows(t, torch.from_numpy(idx).long())
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jout))
    out.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(t.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(cot))[0]),
                               rtol=1e-6, atol=1e-6)


def test_sorted_gather_rows_accumulates_bf16_in_f32():
    """A bf16 table: duplicate ids sum in f32, then one rounding to bf16,
    as the JAX gather_rows, not a bf16 sum rounded after every term."""
    rng = np.random.default_rng(6)
    table = rng.normal(size=(12, 5)).astype(np.float32)
    idx = rng.integers(0, 3, size=(400,)).astype(np.int32)   # ~130 a row
    cot = rng.normal(size=(400, 5)).astype(np.float32)
    jt = jnp.asarray(table).astype(jnp.bfloat16)
    _, vjp = jax.vjp(lambda t: jgather_rows(t, jnp.asarray(idx)), jt)
    jref = np.asarray(vjp(jnp.asarray(cot).astype(jnp.bfloat16))[0].astype(
        jnp.float32))
    t = torch.from_numpy(table).to(torch.bfloat16).requires_grad_(True)
    gcot = torch.from_numpy(cot).to(torch.bfloat16)
    gather_rows(t, torch.from_numpy(idx).long()).backward(gcot)
    assert t.grad.dtype == torch.bfloat16
    f32 = torch.zeros(12, 5).index_add_(0, torch.from_numpy(idx).long(),
                                        gcot.float())
    assert torch.equal(t.grad, f32.to(torch.bfloat16))
    np.testing.assert_allclose(t.grad.float().numpy(), jref, rtol=1e-6,
                               atol=1e-6)
    bf16_terms = torch.zeros(12, 5, dtype=torch.bfloat16)
    for i, r in enumerate(idx):          # a sum rounded after every term
        bf16_terms[r] = bf16_terms[r] + gcot[i]
    assert not torch.equal(t.grad, bf16_terms)


def _scene():
    from sgnerf_tpu.models.aggregator import (AggregatorConfig as JAgg,
                                              init_aggregator_params)
    from sgnerf_tpu.models.point_cloud import make_point_cloud
    from sgnerf_tpu_torch.models import aggregator as tagg
    from sgnerf_tpu_torch.models import point_cloud as tpc
    from sgnerf_tpu_torch.models import renderer as tren
    from sgnerf_tpu_torch.models.params import params_from_jax
    rng = np.random.default_rng(0)
    n = 2000
    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    xyz /= np.linalg.norm(xyz, axis=-1, keepdims=True)
    emb = rng.normal(size=(n, 32)).astype(np.float32) * 0.1
    jcloud = make_point_cloud(xyz, emb, color=(xyz * 0.5 + 0.5), dir=xyz,
                              capacity=2048)
    cloud = tpc.NeuralPointCloud.from_arrays(
        {k: np.asarray(v) for k, v in vars(jcloud).items()}, "cpu")
    spec = tpc.grid_spec_for_cloud(cloud, vsize=[0.05] * 3, vscale=[2, 2, 2],
                                   kernel_size=[3, 3, 3], max_o=8192, P=16)
    cfg = tren.RenderConfig(agg=tagg.AggregatorConfig(act_type="LeakyReLU"),
                            z_depth_dim=80, SR=8, K=4, vsize=(0.05,) * 3)
    params = params_from_jax(jax.tree.map(np.asarray, init_aggregator_params(
        jax.random.key(0), JAgg(act_type="LeakyReLU"))))
    return cloud, tpc.build_grid(cloud, spec), cfg, params


def test_render_gather_vjp_sorted_matches_scatter():
    """cfg.gather_vjp="sorted" renders the same and gives the same cloud
    gradients as the default scatter-add transpose (JAX's
    test_gather_vjp_sorted_matches_scatter_end_to_end, in the port)."""
    from sgnerf_tpu_torch.models.renderer import render_rays
    cloud, grid, cfg, params = _scene()
    rng = np.random.default_rng(1)
    d = rng.normal(size=(1, 16, 3)).astype(np.float32) * 0.2
    d[..., 2] = 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    kw = dict(campos=torch.tensor([[0.0, 0.0, -3.0]]),
              raydir=torch.from_numpy(d), camrotc2w=torch.eye(3)[None],
              near=1.0, far=5.0, bg_color=torch.ones(3))
    res = {}
    for variant in ("scatter", "sorted"):
        emb = cloud.embedding.clone().requires_grad_(True)
        conf = cloud.conf.clone().requires_grad_(True)
        c = dataclasses.replace(cloud, embedding=emb, conf=conf)
        out = render_rays(params, c, grid,
                          dataclasses.replace(cfg, gather_vjp=variant),
                          is_train=True, noise={}, **kw)
        loss = (out["coarse_raycolor"] ** 2).mean()
        loss.backward()
        res[variant] = (float(loss.detach()), emb.grad, conf.grad)
    np.testing.assert_allclose(res["sorted"][0], res["scatter"][0],
                               rtol=1e-6)
    assert float(res["scatter"][1].abs().sum()) > 0
    for a, b in zip(res["sorted"][1:], res["scatter"][1:]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_gather_vjp_sorted_option_resolves_as_in_jax():
    from sgnerf_tpu.options.options import configs_from_opt as jconfigs
    from sgnerf_tpu_torch.options import TestOptions, configs_from_opt
    flags = ["--wcoord_query", "1", "--which_ray_generation",
             "near_far_linear", "--agg_distance_kernel", "linear",
             "--agg_intrp_order", "2", "--gpu_ids", "-1", "--gather_vjp"]
    opt = TestOptions().parse(flags + ["sorted"])
    cfg, _, _ = configs_from_opt(opt)
    jcfg, _, _ = jconfigs(opt)
    assert cfg.gather_vjp == jcfg.gather_vjp == "sorted"
    bad = TestOptions().parse(flags + ["nope"])
    for fn in (configs_from_opt, jconfigs):
        with pytest.raises(ValueError, match="scatter/sorted"):
            fn(bad)


def test_wrappers_refuse_bad_inputs():
    t = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="int32 or int64"):
        gather_rows_pallas(t, torch.zeros(2))
    with pytest.raises(ValueError, match="wave"):
        gather_rows_pallas(t, torch.zeros(2, dtype=torch.int32), wave=0)
    with pytest.raises(ValueError, match="table"):
        gather_rows_staged(torch.zeros(4), torch.zeros(2, dtype=torch.int32))


def test_probe_bound_counts_the_bytes_of_the_run():
    """The probe's bound: each gathered row read and written once, plus the
    ids, over 3.35 TB/s (0.085 ms at the cache shape, 0.137 ms at the
    attribute shape)."""
    from sgnerf_tpu_torch.dev import probe_gather as pg
    table = torch.zeros(10, 320, dtype=torch.int16)
    idx = torch.zeros(7, dtype=torch.int32)
    assert pg.moved_bytes(table, idx) == 2 * 7 * 640 + 7 * 4
    for shape, ms in (("cache", 0.0848), ("attr", 0.1373)):
        c = pg.SHAPES[shape]
        nbytes = 2 * c["S"] * c["ROW"] * 2 + 4 * c["S"]
        assert abs(nbytes / pg.HBM_BPS * 1e3 - ms) < 1e-4
    assert [f[:2] for f in pg.forms()] == (
        [("gather_rows_pallas", w) for w in pg.WAVES]
        + [("gather_rows_staged", w) for w in pg.WAVES]
        + [("index_select", None)])


def _staged_pipe(n, wave):
    """A model of one pipe of `gather_rows_staged_kernel`
    (sgnerf_tpu_torch/csrc/gather_rows.cu): its ring of `wave` slots, one
    mbarrier each, over n rows. It asserts what the card would otherwise
    show as a hang or a wrong row: each wait finds exactly the one load it
    waits for issued on its slot (a missing load never completes the
    phase; a second one would alias its parity), the slot then holds row j,
    and no slot is loaded while a bulk store has yet to read it. Returns
    the rows stored in order."""
    loads = [[] for _ in range(wave)]     # rows loaded into each slot
    pending = []                          # slots of stores not yet read

    def load(slot, row):
        assert slot not in pending, ("slot reloaded before its store read "
                                     "it", n, wave, row)
        loads[slot].append(row)

    for j in range(min(n, wave)):
        load(j, j)
    stored = []
    for j in range(n):
        slot = j % wave
        # bar_wait(slot, parity (j / wave) & 1): phase j / wave completes
        assert len(loads[slot]) == j // wave + 1, ("wait hangs or aliases",
                                                   n, wave, j)
        stored.append(loads[slot][-1])
        pending.append(slot)              # bulk store + commit_group
        if wave == 1:                     # wait_group.read 0
            pending.clear()
            prev = j
        else:                             # wait_group.read 1
            del pending[:-1]
            prev = j - 1
        if prev >= 0 and prev + wave < n:
            load(prev % wave, prev + wave)
    assert sum(map(len, loads)) == n      # no load left in flight at exit
    return stored


def test_staged_ring_schedule_loads_every_row_before_its_wait():
    """The staged kernel's slot and parity schedule, for every wave 1-32
    and every row count a pipe can get (1 .. kRowsPerPipe * wave = 8 wave,
    so counts that are not a multiple of the wave too): every row stored
    once, in order, with no wait that would hang."""
    for wave in range(1, 33):
        for n in range(1, 8 * wave + 1):
            assert _staged_pipe(n, wave) == list(range(n)), (n, wave)
