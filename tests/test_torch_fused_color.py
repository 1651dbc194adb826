"""Kernel K4's plain version (sgnerf_tpu_torch/ops/fused_agg.py
`fused_block1_alpha_color`, CPU tensors) vs the JAX fused_block1_alpha_color
(Pallas, interpret mode on the CPU); its two backwards (autograd of the plain
version, and the composed K2 + colour tail + K3 backward run with their
plain versions) vs the JAX "pallas" backward; and aggregate() with
fused_color vs the reference's.

Tolerances: forward f32 3e-5 (the two sides sum the first layers in
different orders). bf16 1e-2: a one-ulp difference before a cast flips that
input's bf16 rounding (2^-8 relative), and the flip travels through four
colour layers to raw logits of magnitude ~2.5; on such inputs the JAX kernel
and its own XLA statement `_xla_ref_color` differ by up to 9.5e-3.
Gradients rtol 5e-4, atol 2e-5, those of tests/test_fused_agg.py:178. The
neighbour weights sum to at most 1 per point, as the aggregator's
normalised weights times confidences do. M = 150 is not a multiple of the
JAX kernel's 320-row tile.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgnerf_tpu.models import aggregator as jagg
from sgnerf_tpu.ops.fused_agg import fused_block1_alpha_color as jax_color
from sgnerf_tpu_torch.models import aggregator as tagg
from sgnerf_tpu_torch.models.params import params_from_jax
from sgnerf_tpu_torch.ops.fused_agg import (fused_block1_alpha_color,
                                            fused_block1_alpha_color_bwd)
from torch_threads import one_cpu_thread  # noqa: F401

K, NF, DF, VF = 8, 3, 5, 4


@pytest.fixture(scope="module")
def params():
    p = jagg.init_aggregator_params(jax.random.key(2), jagg.AggregatorConfig())
    return jax.tree.map(np.asarray, p)


def _inputs(seed, M=150, F=32, Dd=6):
    rng = np.random.default_rng(seed)
    feat = (rng.normal(size=(M, K, F)) * 0.2).astype(np.float32)
    d = (rng.normal(size=(M, K, Dd)) * 0.05).astype(np.float32)
    w = rng.random((M, K)) * (rng.random((M, K)) < 0.7)
    w = (w / np.maximum(w.sum(-1, keepdims=True), 1e-8)).astype(np.float32)
    vd = rng.normal(size=(M, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    return feat, d, w, vd


def _jax_args(arrays, params):
    return tuple(jnp.asarray(a) for a in arrays) + (
        params["block1"], params["alpha_branch"], params["color_branch"])


def _torch_args(arrays, params):
    tp = params_from_jax(params)
    return tuple(torch.from_numpy(a) for a in arrays) + (
        tp["block1"], tp["alpha_branch"], tp["color_branch"])


def test_plain_versions_run_on_one_cpu_thread():
    """The module's autouse fixture is in force where the plain versions
    run (tests/torch_threads.py)."""
    assert torch.get_num_threads() == 1


@pytest.mark.parametrize("bf16", [False, True])
def test_plain_k4_matches_jax(params, bf16):
    arrays = _inputs(4 if bf16 else 0)
    al, rawc = jax_color(*_jax_args(arrays, params), K=K, nf=NF, df=DF,
                         vf=VF, bf16=bf16)
    tal, trawc = fused_block1_alpha_color(*_torch_args(arrays, params), K=K,
                                          nf=NF, df=DF, vf=VF, bf16=bf16)
    assert tal.shape == (150, 1) and trawc.shape == (150, 3)
    atol = 1e-2 if bf16 else 3e-5
    np.testing.assert_allclose(tal.numpy(), np.asarray(al), atol=atol, rtol=0)
    np.testing.assert_allclose(trawc.numpy(), np.asarray(rawc), atol=atol,
                               rtol=0)


def _flat(grads):
    """(d_feat, d_d, d_w, d_vd, d_block1, d_alpha, d_color) -> list."""
    return list(grads[:4]) + [t for layers in grads[4:] for l_ in layers
                              for t in (l_["w"], l_["b"])]


@pytest.mark.parametrize("route", ["autograd", "composed"])
def test_k4_gradients_match_jax_pallas_backward(params, route):
    """Gradients of all 7 arguments of sum(rgb^2) + 3 sum(alpha^2)."""
    arrays = _inputs(7)

    def loss(*a):
        al, rawc = jax_color(*a, K=K, nf=NF, df=DF, vf=VF, bf16=False,
                             bwd="pallas")
        return jnp.sum(rawc ** 2) + 3.0 * jnp.sum(al ** 2)

    ref = jax.grad(loss, argnums=tuple(range(7)))(*_jax_args(arrays, params))
    ref = list(ref[:4]) + [t for layers in ref[4:] for l_ in layers
                           for t in (l_["w"], l_["b"])]
    args = _torch_args(arrays, params)
    if route == "autograd":
        leaves = [t.requires_grad_(True) for t in args[:4]] + [
            t.requires_grad_(True) for layers in args[4:] for l_ in layers
            for t in (l_["w"], l_["b"])]
        al, rawc = fused_block1_alpha_color(*args, K=K, nf=NF, df=DF, vf=VF,
                                            bf16=False)
        got = torch.autograd.grad((rawc ** 2).sum() + 3.0 * (al ** 2).sum(),
                                  leaves)
    else:
        al, rawc = fused_block1_alpha_color(*args, K=K, nf=NF, df=DF, vf=VF,
                                            bf16=False)
        g = torch.cat([6.0 * al, 2.0 * rawc], dim=-1)
        got = _flat(fused_block1_alpha_color_bwd(
            *args, g, K=K, nf=NF, df=DF, vf=VF, bf16=False))
    assert len(got) == len(ref) == 4 + 2 * (2 + 1 + 4)
    for i, (a, b) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=5e-4, atol=2e-5,
                                   err_msg=f"gradient {i}")


def _agg_inputs(seed, B=1, R=7, SR=5, F=32):
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


@pytest.mark.parametrize("bf16", [False, True])
def test_aggregate_fused_color_matches_reference(params, bf16):
    """The K4 branch of aggregate(): the colour head in the kernel, fed the
    rotated raw view directions."""
    kw = _agg_inputs(3 + int(bf16))
    dt = "bfloat16" if bf16 else "float32"
    jcfg = jagg.AggregatorConfig(fused_mlp="pallas", fused_color=True,
                                 compute_dtype=dt)
    tcfg = tagg.AggregatorConfig(fused_mlp="cuda", fused_color=True,
                                 compute_dtype=dt)
    rot = np.linalg.qr(np.random.default_rng(5).normal(size=(3, 3)))[0]
    rot = rot.astype(np.float32)
    ref = jagg.aggregate(
        params, jcfg, sampled_color=None, sampled_dir=None,
        sampled_label_embedding=None, Rw2c=jnp.asarray(rot),
        vsize=(0.008,) * 3, **{k: jnp.asarray(v) for k, v in kw.items()})
    got = tagg.aggregate(
        params_from_jax(params), tcfg, Rw2c=torch.from_numpy(rot),
        vsize=(0.008,) * 3, **{k: torch.from_numpy(v) for k, v in kw.items()})
    atol = 2e-3 if bf16 else 3e-5
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=atol,
                               rtol=0)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    # the un-fused colour head gives the same decoded values
    plain = tagg.aggregate(
        params_from_jax(params), dataclasses.replace(tcfg, fused_color=False),
        Rw2c=torch.from_numpy(rot), vsize=(0.008,) * 3,
        **{k: torch.from_numpy(v) for k, v in kw.items()})
    np.testing.assert_allclose(got[0].numpy(), plain[0].numpy(), atol=1e-6,
                               rtol=0)


def test_k4_wrapper_rejects_bad_inputs(params):
    args = _torch_args(_inputs(0, M=4), params)
    with pytest.raises(ValueError, match="vf"):
        fused_block1_alpha_color(*args, K=K, nf=NF, df=DF, vf=0, bf16=False)
    with pytest.raises(ValueError, match="vd"):
        fused_block1_alpha_color(*args[:3], args[3][:2], *args[4:], K=K,
                                 nf=NF, df=DF, vf=VF, bf16=False)
    with pytest.raises(ValueError, match="color_branch"):
        fused_block1_alpha_color(*args[:6], args[6][:2], K=K, nf=NF, df=DF,
                                 vf=VF, bf16=False)
