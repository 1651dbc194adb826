"""Kernel K2's plain version (sgnerf_tpu_torch/ops/fused_agg.py) vs the JAX
fused_block1_alpha (Pallas, interpret mode on the CPU), and the port's
aggregate() vs the reference's.

Tolerances: f32 as tests/test_fused_agg.py (3e-5 features, 3e-6 alpha):
the two sides sum the first layer in different orders. bf16 rounds every
matmul input; a one-ulp difference in a sin/cos or hidden value can flip
that input's bf16 rounding (2^-8 relative), which moves features of
magnitude ~16 by up to ~1e-2 and alpha by ~1e-3 — well inside the 0.05 of
tests/test_fused_agg.py:118 (bf16 against f32).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgnerf_tpu.models import aggregator as jagg
from sgnerf_tpu.ops.fused_agg import fused_block1_alpha as jax_fused
from sgnerf_tpu_torch.models import aggregator as tagg
from sgnerf_tpu_torch.models.params import params_from_jax, params_to_jax
from sgnerf_tpu_torch.ops.fused_agg import fused_block1_alpha
from torch_threads import one_cpu_thread  # noqa: F401

TOL = {False: (3e-5, 3e-6), True: (1e-2, 1e-3)}


@pytest.fixture(scope="module")
def params():
    p = jagg.init_aggregator_params(jax.random.key(0), jagg.AggregatorConfig())
    return jax.tree.map(np.asarray, p)


def _inputs(seed, M=333, K=8, F=32, Dd=6):
    rng = np.random.default_rng(seed)
    feat = (rng.normal(size=(M, K, F)) * 0.2).astype(np.float32)
    d = (rng.normal(size=(M, K, Dd)) * 0.05).astype(np.float32)
    w = (rng.random((M, K)) * (rng.random((M, K)) < 0.7)).astype(np.float32)
    return feat, d, w


@pytest.mark.parametrize("bf16", [False, True])
def test_plain_k2_matches_jax_fused(params, bf16):
    feat, d, w = _inputs(int(bf16))
    fa, al = jax_fused(jnp.asarray(feat), jnp.asarray(d), jnp.asarray(w),
                       params["block1"], params["alpha_branch"],
                       K=8, nf=3, df=5, bf16=bf16)
    tp = params_from_jax(params)
    tfa, tal = fused_block1_alpha(
        torch.from_numpy(feat), torch.from_numpy(d), torch.from_numpy(w),
        tp["block1"], tp["alpha_branch"], K=8, nf=3, df=5, bf16=bf16)
    atol_f, atol_a = TOL[bf16]
    np.testing.assert_allclose(tfa.numpy(), np.asarray(fa), atol=atol_f,
                               rtol=0)
    np.testing.assert_allclose(tal.numpy(), np.asarray(al), atol=atol_a,
                               rtol=0)


def test_params_roundtrip(params):
    back = params_to_jax(params_from_jax(params))
    jax.tree.map(np.testing.assert_array_equal, params, back)
    tp = params_from_jax(params)
    assert tp["block1"][0]["w"].shape == params["block1"][0]["w"].shape
    assert tp["block1"][0]["w"].dtype == torch.float32


def test_port_init_matches_reference_shapes():
    cfg = jagg.AggregatorConfig()
    ref = jax.tree.map(lambda a: np.asarray(a).shape,
                       jagg.init_aggregator_params(jax.random.key(0), cfg))
    got = tagg.init_aggregator_params(0, tagg.AggregatorConfig())
    assert jax.tree.map(lambda t: tuple(t.shape), got) == ref
    w = got["block1"][0]["w"]
    lim = np.sqrt(2.0 / 1.0001) * np.sqrt(6.0 / sum(w.shape))
    assert float(w.abs().max()) <= lim and float(w.abs().max()) > 0.9 * lim


def _agg_inputs(seed, B=1, R=7, SR=5, K=8, F=32):
    rng = np.random.default_rng(seed)

    def mk(shape, s=1.0):
        return (rng.normal(size=shape) * s).astype(np.float32)
    return dict(
        sampled_embedding=mk((B, R, SR, K, F), 0.2),
        sampled_conf=np.abs(mk((B, R, SR, K, 1))),
        sampled_xyz=mk((B, R, SR, K, 3)),
        sampled_xyz_pers=mk((B, R, SR, K, 3)),
        sample_pnt_mask=rng.random((B, R, SR, K)) < 0.5,
        sample_loc=mk((B, R, SR, 3)),
        sample_loc_w=mk((B, R, SR, 3)),
        sample_ray_dirs=mk((B, R, SR, 3)),
    )


@pytest.mark.parametrize("fused,bf16", [(False, False), (True, False),
                                        (True, True)])
def test_aggregate_matches_reference(params, fused, bf16):
    kw = _agg_inputs(3)
    dt = "bfloat16" if bf16 else "float32"
    jcfg = jagg.AggregatorConfig(fused_mlp="pallas" if fused else "none",
                                 compute_dtype=dt)
    tcfg = tagg.AggregatorConfig(fused_mlp="cuda" if fused else "none",
                                 compute_dtype=dt)
    ref = jagg.aggregate(
        params, jcfg, sampled_color=None, sampled_dir=None,
        sampled_label_embedding=None, Rw2c=jnp.eye(3), vsize=(0.008,) * 3,
        **{k: jnp.asarray(v) for k, v in kw.items()})
    got = tagg.aggregate(
        params_from_jax(params), tcfg, Rw2c=torch.eye(3), vsize=(0.008,) * 3,
        **{k: torch.from_numpy(v) for k, v in kw.items()})
    # decoded = [alpha | rgb]: sigmoid colours and softplus alphas, bounded
    atol = 2e-3 if bf16 else 3e-5
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=atol,
                               rtol=0)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), rtol=1e-5)


def test_k2_wrapper_rejects_bad_inputs(params):
    feat, d, w = _inputs(0, M=4)
    tp = params_from_jax(params)
    args = (torch.from_numpy(feat), torch.from_numpy(d), torch.from_numpy(w),
            tp["block1"], tp["alpha_branch"])
    with pytest.raises(ValueError):
        fused_block1_alpha(*args, K=4, nf=3, df=5, bf16=False)
    with pytest.raises(ValueError):
        fused_block1_alpha(args[0].double(), *args[1:], K=8, nf=3, df=5,
                           bf16=False)
    with pytest.raises(ValueError):
        fused_block1_alpha(*args[:4], tp["alpha_branch"] * 2, K=8, nf=3,
                           df=5, bf16=False)
