"""Stochastic rounding, the int8 attribute gather and `--knn_mode approx`
in the port against the JAX package on the CPU.

  * `stochastic_round_bf16` on JAX's 16-bit draws gives `_sr_bits`' bits
    exactly (binade edges, negatives, zeros included; subnormals, which
    XLA's CPU backend may flush to zero, by JAX's uint32 rule); its
    gradient is the identity through the cast, as JAX's; the port's own
    draws land on one of x's two bf16 neighbours and average to x.
  * `quantize_table_int8`: q, scale and zero bit-equal to JAX's compiled
    function (XLA multiplies by the float32 reciprocal of 254).
  * `gather_rows_int8`: the forward bit-equal to JAX's compiled gather
    (the dequant is one fused multiply-add there), the VJP (a bf16
    scatter, one upcast) within BF16_ULPS of JAX's.
  * `--knn_mode approx`: the ids equal JAX's approx_max_k ids bit for bit.
  * A train step through a bf16 table (nearest, stochastic on JAX's draws)
    and through the int8 gather matches JAX's; an eval render under int8
    is the bf16 table's, as in JAX.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgnerf_tpu.models import renderer as jren
from sgnerf_tpu.ops import quant as jquant
from sgnerf_tpu_torch.models import renderer as tren
from sgnerf_tpu_torch.ops import quant as tquant
from torch_threads import one_cpu_thread  # noqa: F401
from torch_train_pair import (check_step, configs, port_side, scene,
                              tolerance, train_step_pair)


def _values(case, rng):
    if case == "normal":
        return (rng.normal(size=(300, 11)) * 3).astype(np.float32)
    if case == "edges":
        # just below and at powers of two (the carry into the exponent),
        # zeros of both signs, the largest finite values
        base = np.float32(2.0) ** np.arange(-20, 20, dtype=np.float32)
        below = np.nextafter(base, np.float32(0))
        special = np.array([0.0, -0.0, 3.4e38, -3.4e38], np.float32)
        v = np.concatenate([base, below, -base, -below, special])
        return np.tile(v, (8, 1)).astype(np.float32)
    return rng.uniform(-1, 1, size=(64, 42)).astype(np.float32) * 1e-3


@pytest.mark.parametrize("case", ["normal", "edges", "small"])
def test_stochastic_round_matches_jax_bits(case):
    rng = np.random.default_rng(2)
    x = _values(case, rng)
    key = jax.random.key(9)
    bits = np.array(jax.random.bits(key, x.shape, jnp.uint16))
    want = np.asarray(jquant._sr_bits(jnp.asarray(x), key))
    got = tquant.sr_bits_values(torch.from_numpy(x),
                                torch.from_numpy(bits.view(np.int16)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    jb = np.asarray(jquant.stochastic_round_bf16(jnp.asarray(x), key)
                    .astype(jnp.float32))
    tb = tquant.stochastic_round_bf16(
        torch.from_numpy(x), torch.from_numpy(bits.view(np.int16)))
    assert tb.dtype == torch.bfloat16
    np.testing.assert_array_equal(tb.float().numpy().view(np.uint32),
                                  jb.view(np.uint32))


def test_subnormals_round_on_their_bits():
    """Subnormal inputs round on their bit patterns by JAX's uint32 rule;
    XLA's CPU backend may flush subnormal values to zero inside a fused
    computation, so they are held to the rule, not to a JAX run."""
    x = np.array([[1e-40, -1e-40, 3e-39]], np.float32)
    bits = np.array([[0, 65535, 40000]], np.uint16)
    got = tquant.sr_bits_values(torch.from_numpy(x),
                                torch.from_numpy(bits.view(np.int16)))
    b = x.view(np.uint32).astype(np.uint64)
    want = ((b + bits) & 0xFFFF0000).astype(np.uint32)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_stochastic_round_gradient_is_the_cast_gradient():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(50, 9)).astype(np.float32)
    w = rng.normal(size=(50, 9)).astype(np.float32)
    key = jax.random.key(1)
    bits = np.array(jax.random.bits(key, x.shape, jnp.uint16))
    jg = np.asarray(jax.grad(lambda t: jnp.sum(
        jquant.stochastic_round_bf16(t, key).astype(jnp.float32) * w))(
        jnp.asarray(x)))
    tx = torch.from_numpy(x).requires_grad_(True)
    (tquant.stochastic_round_bf16(tx, torch.from_numpy(bits.view(np.int16)))
     .float() * torch.from_numpy(w)).sum().backward()
    cx = torch.from_numpy(x).requires_grad_(True)
    (cx.to(torch.bfloat16).float() * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(tx.grad.numpy(), jg)
    assert torch.equal(tx.grad, cx.grad)


def test_port_draws_are_unbiased_on_the_bf16_grid():
    """draw_render_noise's sr_bits (int16, all 16 bits) round each value to
    one of its two bf16 neighbours, and 256 draws average to x: the RMS of
    (mean - x) / ulp over the table lies below 1/32, where nearest
    rounding leaves ~0.29."""
    cfg = tren.RenderConfig(gather_dtype="bfloat16",
                            gather_round="stochastic")
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(256, 42)).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    assert "sr_bits" not in tren.draw_render_noise(gen, cfg, 1, 4)
    assert "sr_bits" not in tren.draw_render_noise(
        gen, dataclasses.replace(cfg, gather_round="nearest"), 1, 4,
        table_shape=tuple(x.shape))
    assert "sr_bits" not in tren.draw_render_noise(
        gen, cfg, 1, 4, is_train=False, table_shape=tuple(x.shape))
    b = x.view(torch.int32)
    down = (b & -65536).view(torch.float32)
    up = ((b & -65536) + 65536).view(torch.float32)
    ulp = (up - down).double()
    acc = torch.zeros_like(x, dtype=torch.float64)
    lo, hi = 0, 0
    n = 256
    for _ in range(n):
        bits = tren.draw_render_noise(gen, cfg, 1, 4,
                                      table_shape=tuple(x.shape))["sr_bits"]
        assert bits.dtype == torch.int16 and bits.shape == x.shape
        lo, hi = min(lo, int(bits.min())), max(hi, int(bits.max()))
        r = tquant.stochastic_round_bf16(x, bits).float()
        assert bool(((r == down) | (r == up)).all())
        acc += r.double()
    assert lo < -32000 and hi > 32000
    err = (acc / n - x.double()) / ulp
    assert float(err.pow(2).mean().sqrt()) < 1 / 32
    near = (x.to(torch.bfloat16).double() - x.double()) / ulp
    assert float(near.pow(2).mean().sqrt()) > 0.25


@pytest.mark.parametrize("mask", ["random", "all", "none", "one_row"])
def test_quantize_table_int8_matches_jax(mask):
    rng = np.random.default_rng(5)
    N, C = 400, 42
    x = (rng.normal(size=(N, C))
         * rng.uniform(1e-3, 50, size=C)).astype(np.float32)
    x[:, 7] = 0.25                                 # a constant channel
    act = {"random": rng.uniform(size=N) < 0.8, "all": np.ones(N, bool),
           "none": np.zeros(N, bool),
           "one_row": np.arange(N) == 3}[mask]
    x[~act] = 1e9                                  # the capacity padding
    want = jax.jit(jquant.quantize_table_int8)(jnp.asarray(x),
                                                jnp.asarray(act))
    got = tquant.quantize_table_int8(torch.from_numpy(x),
                                     torch.from_numpy(act))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].dtype == torch.int8


def test_gather_rows_int8_matches_jax():
    rng = np.random.default_rng(6)
    N, C = 300, 42
    x = (rng.normal(size=(N, C)) * rng.uniform(0.01, 20, C)).astype(
        np.float32)
    act = rng.uniform(size=N) < 0.9
    x[~act] = 1e9
    pools = [rng.choice(N, 9, replace=False) for _ in range(6)]
    idx = np.stack([p[rng.integers(0, 9, 24)] for p in pools]).reshape(
        1, 6, 4, 6)
    cot = rng.normal(size=idx.shape + (C,)).astype(np.float32)
    out, vjp = jax.vjp(
        lambda t: jax.jit(jren.gather_rows_int8)(t, jnp.asarray(idx),
                                                 jnp.asarray(act)),
        jnp.asarray(x))
    jg = np.asarray(vjp(jnp.asarray(cot))[0])
    tx = torch.from_numpy(x).requires_grad_(True)
    got = tren.gather_rows_int8(tx, torch.from_numpy(idx).long(),
                                torch.from_numpy(act))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(out))
    got.backward(torch.from_numpy(cot))
    assert tx.grad.dtype == torch.float32
    np.testing.assert_allclose(tx.grad.numpy(), jg, rtol=0,
                               atol=tolerance(idx, cot))


def test_knn_approx_ids_match_jax():
    """JAX's approx_max_k is exact off the TPU; the port's approx mode is
    the exact select: the ids are JAX's bit for bit."""
    from sgnerf_tpu.ops.query import query_neighbors as jquery
    from sgnerf_tpu.ops.raygen import find_ray_generation_method
    from sgnerf_tpu_torch.ops.query import query_neighbors as tquery
    jcloud, jgrid, jparams, batch = scene(R=48)
    _, tcfg = configs({})
    tcloud, _, tgrid = port_side(jcloud, jparams)
    raypos = find_ray_generation_method("near_far_linear")(
        jnp.asarray(batch["campos"]), jnp.asarray(batch["raydir"]), 48,
        near=1.0, far=5.0)[0]
    kw = dict(K=tcfg.K, SR=tcfg.SR, radius_limit=tcfg.radius_limit)
    want = jquery(jgrid, jcloud.xyz, raypos, knn_mode="approx", **kw)
    got = tquery(tgrid, torch.from_numpy(np.array(raypos)),
                 knn_mode="approx", **kw)
    exact = tquery(tgrid, torch.from_numpy(np.array(raypos)),
                   knn_mode="exact", **kw)
    ids = np.asarray(want.sample_pidx)
    assert (ids >= 0).sum() > 100
    np.testing.assert_array_equal(got.sample_pidx.numpy(), ids)
    assert torch.equal(got.sample_pidx, exact.sample_pidx)


@pytest.mark.parametrize("cfg_kw", [
    dict(gather_dtype="bfloat16"),
    dict(gather_dtype="bfloat16", gather_round="stochastic"),
    dict(gather_dtype="bfloat16", gather_round="stochastic",
         gather_vjp="batchdedup", knn_mode="approx"),
    dict(gather_dtype="int8"),
], ids=["bf16", "bf16-stochastic", "bf16-stochastic-batchdedup-approx",
        "int8"])
def test_train_step_matches_jax(cfg_kw):
    jl, tl, js, ts, seen = train_step_pair(cfg_kw)
    check_step(jl, tl, js, ts, seen)


def test_stochastic_rounding_needs_its_draws():
    jcloud, jgrid, jparams, batch = scene(R=8)
    _, cfg = configs(dict(gather_dtype="bfloat16", gather_round="stochastic"))
    tcloud, _, tgrid = port_side(jcloud, jparams)
    kw = dict(campos=torch.from_numpy(batch["campos"]),
              raydir=torch.from_numpy(batch["raydir"]),
              camrotc2w=torch.from_numpy(batch["camrotc2w"]),
              near=1.0, far=5.0, is_train=True)
    with pytest.raises(ValueError, match="sr_bits"):
        tren.render_rays({}, tcloud, tgrid, cfg, noise={}, **kw)


def test_int8_eval_render_is_the_bf16_tables():
    """Eval renders under --gather_dtype int8 read the bf16 table, in both
    packages: the port's int8 frame is its bf16 frame, and JAX's within
    1e-5."""
    from sgnerf_tpu_torch.models.params import params_from_jax
    jcloud, jgrid, jparams, batch = scene(R=24)
    jcfg, cfg = configs(dict(gather_dtype="int8"))
    tcloud, _, tgrid = port_side(jcloud, jparams)
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    kw = {k: torch.from_numpy(np.asarray(batch[k]))
          for k in ("campos", "raydir", "camrotc2w", "bg_color")}
    with torch.no_grad():
        a = tren.render_rays(params, tcloud, tgrid, cfg, near=1.0, far=5.0,
                             **kw)["coarse_raycolor"]
        b = tren.render_rays(
            params, tcloud, tgrid,
            dataclasses.replace(cfg, gather_dtype="bfloat16"), near=1.0,
            far=5.0, **kw)["coarse_raycolor"]
    assert torch.equal(a, b)
    want = jren.render_rays(
        jparams, jcloud, jgrid, jcfg, near=1.0, far=5.0,
        **{k: jnp.asarray(v.numpy()) for k, v in kw.items()})
    np.testing.assert_allclose(a.numpy(), np.asarray(
        want["coarse_raycolor"]), atol=1e-5, rtol=0)
    assert float((a - 1.0).abs().max()) > 1e-3     # rays hit points
