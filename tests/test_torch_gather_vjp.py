"""The six attribute-gather transposes (`--gather_vjp`) and their overflow
counts in the port against the JAX package on the CPU.

  * Each transpose on duplicate-heavy ids (a pool of a few ids a tile, as
    tests/test_renderer.py draws them): the forward bit-equal, the table
    gradient within 1e-5 on a float32 table and, on a bf16 table, within
    BF16_ULPS: the largest count of one id's duplicates times one bf16 ulp
    of the largest sum of |cotangent| over an id's rows (the bf16 sums
    round at each term, in another order on the card). Undersized caps
    (raydedup's U, batchdedup's U_cap) drop the same rows as JAX.
  * `dedup_overflow_count` and `batchdedup_overflow_count` equal JAX's,
    at caps below, at and above the distinct count.
  * One train step on a bf16 table under each transpose: losses within
    1e-5 of JAX and bit-equal across the six, the updated point fields
    within the Adam step's tolerance; the overflow count rides the losses.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgnerf_tpu.models import renderer as jren
from sgnerf_tpu_torch.models import renderer as tren
from torch_threads import one_cpu_thread  # noqa: F401
from torch_train_pair import (check_step, configs, port_noise, port_side,
                              recording_cotangents, scene, tolerance,
                              torch_batch, train_step_pair)

VARIANTS = ("scatter", "sorted", "f32", "spread", "raydedup", "batchdedup")


def _jax_take(variant, cfg, rows):
    if variant == "scatter":
        return lambda t, i: t[i]
    if variant == "sorted":
        return jren.gather_rows
    if variant == "f32":
        return jren.gather_rows_f32acc
    if variant == "spread":
        return jren.make_gather_rows_spread(cfg.spread_J, cfg.K)
    if variant == "raydedup":
        return jren.make_gather_rows_dedup(cfg.gvjp_rows or cfg.SR * cfg.K,
                                           cfg.gvjp_U)
    return jren.make_gather_rows_batchdedup(
        cfg.gvjp_batch_U or max(4096, rows * 2 // 3))


def _ids(rng, n, tiles, T, pool):
    """tiles x T ids, each tile drawn from its own pool of `pool` ids."""
    pools = [rng.choice(n, size=pool, replace=False) for _ in range(tiles)]
    return np.stack([p[rng.integers(0, pool, size=T)] for p in pools])


# (variant, spread_J, gvjp_U, gvjp_batch_U): the defaults, then caps that
# drop rows (raydedup keeps 4 of each tile's <= 9 distinct ids, batchdedup
# 20 of the batch's)
CASES = [(v, 4, 128, 0) for v in VARIANTS] + [
    ("spread", 3, 128, 0), ("raydedup", 4, 4, 0), ("batchdedup", 4, 128, 20)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant,J,U,bU", CASES,
                         ids=[f"{c[0]}-J{c[1]}-U{c[2]}-bU{c[3]}"
                              for c in CASES])
def test_transpose_matches_jax(variant, J, U, bU, dtype):
    rng = np.random.default_rng(7)
    n, C, SR, K = 60, 7, 4, 6                  # tiles of SR*K = 24 rows
    cfg = tren.RenderConfig(SR=SR, K=K, gather_vjp=variant, spread_J=J,
                            gvjp_U=U, gvjp_batch_U=bU)
    idx = _ids(rng, n, 5, SR * K, 9).reshape(1, 5, SR, K)
    table = rng.normal(size=(n, C)).astype(np.float32)
    cot = rng.normal(size=idx.shape + (C,)).astype(np.float32)
    jt, tt = jnp.float32, torch.float32
    if dtype == "bfloat16":
        jt, tt = jnp.bfloat16, torch.bfloat16
    jtab = jnp.asarray(table, jt)
    take = _jax_take(variant, cfg, idx.size)
    jout, vjp = jax.vjp(lambda t: take(t, jnp.asarray(idx)), jtab)
    jg = np.asarray(vjp(jnp.asarray(cot, jt))[0].astype(jnp.float32))

    ttab = torch.from_numpy(table).to(tt).requires_grad_(True)
    tid = torch.from_numpy(idx).long()
    out = tren._Gather.apply(ttab, tid, tren.gather_transpose(cfg, idx.size))
    assert torch.equal(out.float(), torch.from_numpy(
        np.array(jout.astype(jnp.float32))))
    out.backward(torch.from_numpy(cot).to(tt))
    assert ttab.grad.dtype == tt
    tg = ttab.grad.float().numpy()
    atol = 1e-5 if dtype == "float32" else tolerance(idx, cot)
    np.testing.assert_allclose(tg, jg, atol=atol, rtol=0)
    if (variant, U, bU) in (("raydedup", 4, 0), ("batchdedup", 128, 20)):
        # the cap dropped rows: some ids' gradient is zero in both
        full = np.zeros_like(tg)
        np.add.at(full, idx.reshape(-1), cot.reshape(-1, C))
        assert np.abs(full - tg).max() > 1.0


@pytest.mark.parametrize("cap", [3, 9, 200])
def test_overflow_counts_match_jax(cap):
    """Both overflow counts on one batch, at caps below, at and above the
    distinct counts; -1 when the rows do not tile."""
    rng = np.random.default_rng(11)
    idx = _ids(rng, 500, 8, 24, 9).reshape(1, 8, 4, 6)
    idx[0, 0, 0, :3] = -1                      # empty slots count as id 0
    j, t = jnp.asarray(idx, jnp.int32), torch.from_numpy(idx)
    for U in (cap, 6):
        assert int(tren.dedup_overflow_count(t, 24, U)) == int(
            jren.dedup_overflow_count(j, 24, U))
    assert int(tren.dedup_overflow_count(t, 25, cap)) == -1 == int(
        jren.dedup_overflow_count(j, 25, cap))
    n_uniq = len(np.unique(np.clip(idx, 0, None)))
    for U_cap in (cap * 5, n_uniq, n_uniq - 1):
        got = int(tren.batchdedup_overflow_count(t, U_cap))
        assert got == int(jren.batchdedup_overflow_count(j, U_cap))
        assert got == max(n_uniq - U_cap, 0)
    assert int(tren.batchdedup_overflow_count(t, n_uniq - 1)) == 1


# ------------------------------------------------------ the train step

@pytest.mark.parametrize("variant", VARIANTS)
def test_train_step_under_each_transpose_matches_jax(variant):
    """One step on a bf16 table under each transpose matches JAX's; only
    raydedup and batchdedup report an overflow, 0 here."""
    jl, tl, js, ts, seen = train_step_pair(
        dict(gather_dtype="bfloat16", gather_vjp=variant))
    check_step(jl, tl, js, ts, seen)
    assert ("gvjp_overflow" in tl) == (variant in ("raydedup", "batchdedup"))
    if "gvjp_overflow" in tl:
        assert float(tl["gvjp_overflow"]) == 0.0


def test_the_six_transposes_give_bit_equal_losses():
    """The loss does not depend on the transpose: one step's losses under
    the six are bit-equal, and each one's point gradients lie within
    BF16_ULPS (of the step's own cotangent rows) of the f32 transpose's
    (port only)."""
    from sgnerf_tpu_torch.models.train import TrainConfig, loss_and_grads
    jcloud, jgrid, jparams, batch = scene()
    jcfg, cfg = configs(dict(gather_dtype="bfloat16"))
    losses, grads = {}, {}
    with recording_cotangents([]) as seen:
        for v in VARIANTS:
            tcloud, state, grid = port_side(jcloud, jparams)
            noise = port_noise(jcfg, jgrid, tcloud, 32, jax.random.key(5))
            loss, _, g_pts = loss_and_grads(
                state, grid, dataclasses.replace(cfg, gather_vjp=v),
                TrainConfig(color_grad=1), torch_batch(batch), noise=noise)
            losses[v], grads[v] = loss["total"], g_pts
    assert all(torch.equal(x, losses["f32"]) for x in losses.values())
    lim = tolerance(*seen[0])
    assert all(np.array_equal(f, seen[0][0]) for f, _ in seen)
    for v in VARIANTS:
        for a, b in zip(grads[v], grads["f32"]):
            assert float((a - b).abs().max()) <= lim, v


def test_raydedup_overflow_rides_the_losses():
    """A raydedup cap of 2 distinct ids a ray drops rows: the losses report
    JAX's count, and the step still matches JAX."""
    jl, tl, js, ts, seen = train_step_pair(
        dict(gather_vjp="raydedup", gvjp_U=2))
    assert float(tl["gvjp_overflow"]) == float(jl["gvjp_overflow"]) > 0
    check_step(jl, tl, js, ts, seen, bf16=False)
